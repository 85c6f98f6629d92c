"""The yardstick's arithmetic, frozen here so that no change to the program
changes it: the card's published peaks, the feature levels of a ResNet
input, the deformable-attention operation's corners, multiply-adds and
least time (copies of the program's ``msda_corners``/``msda_fmas`` and of
``chip_smoke.py::msda_bound`` as they stood when the benchmark was
written), and a model's forward FLOPs counted on the plain reference."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAKS = {"bf16_flop_per_s": 989e12, "tf32_flop_per_s": 495e12,
         "fp32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def level_shapes(hw: Sequence[int], n_levels: int) -> List[Tuple[int, int]]:
    """(H, W) of ResNet's C3, C4, C5 and the stride-2 levels after them for
    an input of ``hw``: the 7x7/2 stem, the 3x3/2 max pool, then one
    stride-2 3x3 (padding 1) a level."""
    def half(n):                    # 3x3, stride 2, padding 1
        return (n - 1) // 2 + 1
    h, w = ((hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)   # 7x7/2, pad 3
    h, w = half(h), half(w)                                 # max pool
    h, w = half(h), half(w)                                 # C3, stride 8
    out = [(h, w)]
    while len(out) < n_levels:
        h, w = half(h), half(w)
        out.append((h, w))
    return out


def msda_corners(shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                 w: torch.Tensor):
    """The four bilinear corners of every sampling point: (cx, cy, ok),
    each (B, Lq, nH, L, P); ok where the corner falls inside its level and
    the point's attention weight is nonzero."""
    wl = torch.tensor([s[1] for s in shapes], device=loc.device)[:, None]
    hl = torch.tensor([s[0] for s in shapes], device=loc.device)[:, None]
    x = torch.floor(loc[..., 0].float() * wl - 0.5).long()
    y = torch.floor(loc[..., 1].float() * hl - 0.5).long()
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x + dx, y + dy
            ok = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl) & (w != 0)
            corners.append((cx, cy, ok))
    return corners


def msda_fmas(value_shape, shapes, loc, w) -> int:
    """Multiply-adds of one call: one per channel of each corner."""
    return value_shape[-1] * sum(int(ok.sum())
                                 for _, _, ok in msda_corners(shapes, loc, w))


def msda_bound(value_shape, item_bytes, shapes, loc, w) -> Dict:
    """The least time the card could take for one call: each value row
    (b, s, h) that a corner of nonzero weight touches read once, all of loc
    and w read once, the output written once, against the HBM rate; two
    operations a multiply-add against the float32 rate (the kernel sums in
    float32). Returns {"ms", "by", "bytes", "fmas"}."""
    B, len_v, nH, C = value_shape
    wl = torch.tensor([wd for _, wd in shapes], device=loc.device)[:, None]
    start = torch.tensor([0] + [h * wd for h, wd in shapes][:-1],
                         device=loc.device).cumsum(0)[:, None]
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1, 1)
    h = torch.arange(nH, device=loc.device).view(1, 1, nH, 1, 1)
    rows = [((b * len_v + start + cy * wl + cx) * nH + h)[ok]
            for cx, cy, ok in msda_corners(shapes, loc, w)]
    n_rows = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (n_rows * C + loc.numel() + w.numel()
              + loc.shape[0] * loc.shape[1] * nH * C) * item_bytes
    fmas = msda_fmas(value_shape, shapes, loc, w)
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    t_ops = 2 * fmas / PEAKS["fp32_flop_per_s"] * 1e3
    return {"ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "fmas": fmas}


def forward_flops(arch, cfg, hw: Sequence[int], batch: int = 1) -> int:
    """FLOPs of the reference model's forward on ``batch`` images of
    ``hw``, counted by ``FlopCounterMode`` on the meta device (matrix
    products and convolutions), plus deformable attention's two operations
    a multiply-add by the frozen formula. The same whatever implements the
    model."""
    from torch.utils.flop_counter import FlopCounterMode
    from .nn import Precision
    from .weights import meta_weights
    p = meta_weights(arch.param_specs(cfg))
    images = torch.empty(batch, hw[0], hw[1], 3, device="meta")
    mask = torch.zeros(batch, hw[0], hw[1], device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        arch.forward(p, images, mask, cfg, Precision("float32"))
    return int(counter.get_total_flops()) + 2 * arch.msda_fmas(cfg, batch, hw)
