"""RAFT (princeton-vl/RAFT, ``core/raft.py``, the standard model) in plain
float32, NCHW, as ``evaluate.py::validate_sintel`` serves it: frames in
[-1, 1], padded to a multiple of 8, ``iters`` refinement steps, the last
flow upsampled 8x by the convex mask and cropped back.

- ``BasicEncoder`` (``core/extractor.py``): a 7x7/2 stem, three stages of
  two residual blocks (64, 96, 128 wide), a 1x1 projection; instance norm
  without affine for the feature encoder, BatchNorm in eval mode (running
  statistics) for the context encoder.
- ``CorrBlock`` (``core/corr.py``): the all-pairs volume over sqrt(C), its
  ``avg_pool2d`` levels, and each step's lookup by ``F.grid_sample``
  (``align_corners=True``, zeros outside) of a (2r+1)^2 window a level,
  the offsets added to (x, y) in ``meshgrid(dy, dx)`` order: the x offset
  on the outer axis.
- ``BasicUpdateBlock`` (``core/update.py``): the motion encoder, the
  separable ConvGRU (1x5 then 5x1), the flow head and the mask head with
  its 0.25 scale; ``upsample_flow``'s convex combination.

Departures, each in the configuration's ``reduced`` or ``assumed``:

- padding: zeros in the [-1, 1] space with ``Padder``'s sintel placement
  (centred on both axes), as the port pads; princeton-vl's ``InputPadder``
  replicates the border rows;
- the mask head and the upsampling run after the last step only: the mask
  never feeds the recurrence, so the flow served is the same as
  princeton-vl's last ``flow_up``;
- a level one pixel high or wide is sampled with a zero row or column
  beside it, so that ``grid_sample``'s corner-aligned normalisation
  (``2x / (W - 1) - 1``) is defined; zeros outside make it the same
  sample. No level of a Sintel frame is that small.

Parameter names are the port's ``state_dict``'s, which are princeton-vl's.
Every convolution and matrix product goes through a ``Precision``."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..nn import conv2d

NORM_EPS = 1e-5


def _conv_specs(name, cout, cin, kh, kw=None):
    return [(f"{name}.weight", (cout, cin, kh, kw or kh), "lecun"),
            (f"{name}.bias", (cout,), "zeros")]


def _bn_specs(name, c):
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.running_mean", (c,), "zeros"),
            (f"{name}.running_var", (c,), "ones"),
            (f"{name}.num_batches_tracked", (), "zeros")]


def _encoder_specs(prefix, dims, out_dim, batch_norm) -> List:
    norm = _bn_specs if batch_norm else (lambda name, c: [])
    specs = _conv_specs(f"{prefix}.conv1", dims[0], 3, 7)
    specs += norm(f"{prefix}.norm1", dims[0])
    for i, (cin, planes, stride) in enumerate(zip(dims, dims[1:],
                                                  (1, 2, 2))):
        for j in range(2):
            b = f"{prefix}.layer{i + 1}.{j}"
            specs += _conv_specs(f"{b}.conv1", planes, cin if j == 0
                                 else planes, 3)
            specs += _conv_specs(f"{b}.conv2", planes, planes, 3)
            specs += norm(f"{b}.norm1", planes) + norm(f"{b}.norm2", planes)
            if j == 0 and stride != 1:
                specs += norm(f"{b}.norm3", planes)
                specs += _conv_specs(f"{b}.downsample.0", planes, cin, 1)
    return specs + _conv_specs(f"{prefix}.conv2", out_dim, dims[-1], 1)


def corr_channels(cfg) -> int:
    return cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2


def param_specs(cfg) -> List:
    """(name, shape, init) of every weight and BatchNorm statistic."""
    dims, hd, cd = cfg["encoder_dims"], cfg["hidden_dim"], cfg["context_dim"]
    c1, c2, f1, f2, mo = cfg["motion_dims"]
    specs = _encoder_specs("fnet", dims, cfg["fnet_dim"], False)
    specs += _encoder_specs("cnet", dims, hd + cd, True)
    u = "update_block"
    specs += _conv_specs(f"{u}.encoder.convc1", c1, corr_channels(cfg), 1)
    specs += _conv_specs(f"{u}.encoder.convc2", c2, c1, 3)
    specs += _conv_specs(f"{u}.encoder.convf1", f1, 2, 7)
    specs += _conv_specs(f"{u}.encoder.convf2", f2, f1, 3)
    specs += _conv_specs(f"{u}.encoder.conv", mo, c2 + f2, 3)
    gru_in = hd + cd + mo + 2
    k = cfg["gru_kernel"]
    for i, (kh, kw) in enumerate(((1, k), (k, 1)), 1):
        for gate in ("z", "r", "q"):
            specs += _conv_specs(f"{u}.gru.conv{gate}{i}", hd, gru_in, kh, kw)
    specs += _conv_specs(f"{u}.flow_head.conv1", cfg["flow_head_dim"], hd, 3)
    specs += _conv_specs(f"{u}.flow_head.conv2", 2, cfg["flow_head_dim"], 3)
    specs += _conv_specs(f"{u}.mask.0", cfg["mask_dim"], hd, 3)
    specs += _conv_specs(f"{u}.mask.2", 9 * cfg["upsample"] ** 2,
                         cfg["mask_dim"], 1)
    return specs


def aliases(cfg) -> Dict[str, str]:
    """A strided block's shortcut norm is registered twice (``norm3`` and
    ``downsample.1``), as in princeton-vl's ``ResidualBlock``."""
    out = {}
    for stage in (2, 3):
        b = f"cnet.layer{stage}.0"
        for k in ("weight", "bias", "running_mean", "running_var",
                  "num_batches_tracked"):
            out[f"{b}.downsample.1.{k}"] = f"{b}.norm3.{k}"
    return out


# frames ---------------------------------------------------------------
def normalised(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 (B, 3, H, W) in [-1, 1]
    (``2 * (x / 255) - 1``)."""
    x = 2 * (frames.float() / 255.0) - 1.0
    return x.permute(0, 3, 1, 2).contiguous()


def padding(hw: Sequence[int], mult: int = 8) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) to the next multiple of ``mult``, centred
    on both axes (the sintel placement)."""
    pad_h, pad_w = (-hw[0]) % mult, (-hw[1]) % mult
    return pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2


def padded_hw(hw: Sequence[int]) -> Tuple[int, int]:
    left, right, top, bottom = padding(hw)
    return hw[0] + top + bottom, hw[1] + left + right


def unpad(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    left, right, top, bottom = pad
    H, W = x.shape[-2:]
    return x[..., top:H - bottom, left:W - right]


# encoders ---------------------------------------------------------------
def _norm(x, p, name, batch_norm):
    if not batch_norm:
        return F.instance_norm(x, eps=NORM_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=False, eps=NORM_EPS)


def encoder(x, p, prefix, cfg, batch_norm, P):
    """``BasicEncoder``: (B, 3, H, W) -> (B, C, H/8, W/8)."""
    x = conv2d(x, p, f"{prefix}.conv1", P, stride=2, padding=3, bias=True)
    x = F.relu(_norm(x, p, f"{prefix}.norm1", batch_norm))
    for i, stride in enumerate((1, 2, 2)):
        for j in range(2):
            b = f"{prefix}.layer{i + 1}.{j}"
            s = stride if j == 0 else 1
            y = conv2d(x, p, f"{b}.conv1", P, stride=s, padding=1, bias=True)
            y = F.relu(_norm(y, p, f"{b}.norm1", batch_norm))
            y = conv2d(y, p, f"{b}.conv2", P, padding=1, bias=True)
            y = F.relu(_norm(y, p, f"{b}.norm2", batch_norm))
            if s != 1:
                x = _norm(conv2d(x, p, f"{b}.downsample.0", P, stride=s,
                                 bias=True), p, f"{b}.norm3", batch_norm)
            x = F.relu(x + y)
    return conv2d(x, p, f"{prefix}.conv2", P, bias=True)


# correlation ------------------------------------------------------------
def corr_pyramid(fmap1, fmap2, levels, P) -> List[torch.Tensor]:
    """``CorrBlock``'s pyramid: (B * H * W, 1, Hl, Wl) a level."""
    B, C, H, W = fmap1.shape
    f1 = fmap1.reshape(B, C, H * W).transpose(1, 2)
    f2 = fmap2.reshape(B, C, H * W)
    corr = torch.matmul(P.q(f1), P.q(f2)) / math.sqrt(C)
    out = [corr.reshape(B * H * W, 1, H, W)]
    for _ in range(levels - 1):
        out.append(F.avg_pool2d(out[-1], 2, stride=2))
    return out


def _sample(level, xy):
    """``bilinear_sampler``: level (M, 1, h, w) at pixel (x, y) (M, d, d, 2)
    -> (M, 1, d, d), zeros outside."""
    h, w = level.shape[-2:]
    if h == 1 or w == 1:        # see the module's departures
        level = F.pad(level, (0, int(w == 1), 0, int(h == 1)))
        h, w = level.shape[-2:]
    x, y = xy.split([1, 1], -1)
    grid = torch.cat([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], -1)
    return F.grid_sample(level, grid, align_corners=True)


def lookup(pyramid, coords, radius) -> torch.Tensor:
    """``CorrBlock.__call__``: coords (B, 2, H, W) as (x, y) -> (B,
    L * (2r+1)^2, H, W)."""
    B, _, H, W = coords.shape
    r = radius
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
    centre = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2)
    out = []
    for i, level in enumerate(pyramid):
        xy = centre / 2 ** i + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
        out.append(_sample(level, xy).view(B, H, W, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous()


# update -----------------------------------------------------------------
def update(p, net, inp, corr, flow, cfg, P):
    """``BasicUpdateBlock`` without its mask head: (net, delta flow)."""
    e = "update_block.encoder"
    c = F.relu(conv2d(corr, p, f"{e}.convc1", P, bias=True))
    c = F.relu(conv2d(c, p, f"{e}.convc2", P, padding=1, bias=True))
    f = F.relu(conv2d(flow, p, f"{e}.convf1", P, padding=3, bias=True))
    f = F.relu(conv2d(f, p, f"{e}.convf2", P, padding=1, bias=True))
    m = F.relu(conv2d(torch.cat([c, f], 1), p, f"{e}.conv", P, padding=1,
                      bias=True))
    x = torch.cat([inp, m, flow], 1)
    h, k = net, cfg["gru_kernel"]
    g = "update_block.gru"
    for i, pad in ((1, (0, k // 2)), (2, (k // 2, 0))):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(conv2d(hx, p, f"{g}.convz{i}", P, padding=pad,
                                 bias=True))
        r = torch.sigmoid(conv2d(hx, p, f"{g}.convr{i}", P, padding=pad,
                                 bias=True))
        q = torch.tanh(conv2d(torch.cat([r * h, x], 1), p, f"{g}.convq{i}",
                              P, padding=pad, bias=True))
        h = (1 - z) * h + z * q
    fh = "update_block.flow_head"
    delta = conv2d(F.relu(conv2d(h, p, f"{fh}.conv1", P, padding=1,
                                 bias=True)), p, f"{fh}.conv2", P, padding=1,
                   bias=True)
    return h, delta


def mask(p, net, P):
    """The mask head, scaled by 0.25."""
    m = F.relu(conv2d(net, p, "update_block.mask.0", P, padding=1, bias=True))
    return 0.25 * conv2d(m, p, "update_block.mask.2", P, bias=True)


def upsample_flow(flow, up_mask, scale):
    """``upsample_flow``: the convex combination of each fine pixel's 3x3
    coarse neighbours (zeros outside), softmax-weighted by the mask."""
    N, _, H, W = flow.shape
    m = torch.softmax(up_mask.view(N, 1, 9, scale, scale, H, W), dim=2)
    up = F.unfold(scale * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
    up = torch.sum(m * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(N, 2, scale * H, scale * W)


def coords_grid(B, H, W, device):
    y, x = torch.meshgrid(torch.arange(H, device=device),
                          torch.arange(W, device=device), indexing="ij")
    return torch.stack([x, y]).float()[None].expand(B, 2, H, W)


def forward(p, image1, image2, cfg, P, iters) -> torch.Tensor:
    """Padded frames (B, 3, H, W) in [-1, 1] -> the flow (B, 2, H, W)
    after ``iters`` steps."""
    hd = cfg["hidden_dim"]
    B = image1.shape[0]
    fmaps = encoder(torch.cat([image1, image2]), p, "fnet", cfg, False, P)
    pyramid = corr_pyramid(fmaps[:B], fmaps[B:], cfg["corr_levels"], P)
    c = encoder(image1, p, "cnet", cfg, True, P)
    net, inp = torch.tanh(c[:, :hd]), torch.relu(c[:, hd:])
    H8, W8 = fmaps.shape[-2:]
    coords0 = coords_grid(B, H8, W8, image1.device)
    coords1 = coords0
    for _ in range(iters):
        corr = lookup(pyramid, coords1, cfg["corr_radius"])
        net, delta = update(p, net, inp, corr, coords1 - coords0, cfg, P)
        coords1 = coords1 + delta
    return upsample_flow(coords1 - coords0, mask(p, net, P), cfg["upsample"])


def flows(p, frames1, frames2, cfg, P, iters) -> torch.Tensor:
    """uint8 frames (B, H, W, 3), both sides -> the flow (B, 2, H, W) as
    served: normalised, padded, ``forward``, cropped."""
    pad = padding(frames1.shape[1:3])
    image1, image2 = (F.pad(normalised(f), pad) for f in (frames1, frames2))
    return unpad(forward(p, image1, image2, cfg, P, iters), pad)
