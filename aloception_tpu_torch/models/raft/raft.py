"""RAFT: Recurrent All-Pairs Field Transforms for optical flow (counterpart
of ``aloception_tpu/models/raft/raft.py``), NCHW.

The feature encoder runs on both frames at once (instance norm is per
sample), the context encoder on the first; their all-pairs correlation is one
fp32 matmul, average-pooled into a pyramid. Then ``iters`` steps of one
shared update block, a plain Python loop: look up the pyramid around the
current coordinates (detached), update the GRU state, add the flow delta.
Each step's flow is upsampled 8x by the convex combination the mask head
weighs (bilinearly for RAFT-small).

``only_last`` is the serving path: iters - 1 steps without the mask head,
one step with it and one upsample, and the pyramid in the model's dtype. The
other path returns every step's upsampled flow, with the pyramid in float32.

Dtypes follow the JAX package: the feature maps, the correlation volume,
the GRU state, the coordinates and the upsampling are float32; convs run in
the model's dtype, their inputs cast to it (the context, which feeds convs
only, is kept in that dtype).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...aloscene import Flow
from ...ops.correlation import CorrPyramid, corr_pyramid, corr_volume
from ...ops.warp import coords_grid
from ..transformers import entry_device, init_parameters
from .extractor import BasicEncoder, SmallEncoder
from .update import BasicUpdateBlock, SmallUpdateBlock


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W) -> (B, 2, 8H, 8W): bilinear with aligned corners, values
    scaled by 8."""
    H, W = flow.shape[-2:]
    return F.interpolate(flow, size=(8 * H, 8 * W), mode="bilinear",
                         align_corners=True) * 8.0


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (B, 2, H, W), mask (B, 9 * 64, H, W) -> (B, 2, 8H, 8W): each fine
    pixel (u, v) of a coarse pixel is the softmax-weighted sum of 8x the
    coarse flow at its 3x3 neighbours (zero outside). Mask channel
    k * 64 + u * 8 + v: the tap k = 3 * dy + dx outer, then (u, v), the
    reference's layout."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.view(B, 1, 9, 8, 8, H, W), dim=2)
    taps = F.unfold(8.0 * flow, 3, padding=1).view(B, 2, 9, 1, 1, H, W)
    up = (m * taps).sum(2)                              # (B, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


class RAFTBase(nn.Module):
    """Frames (B, 3, H, W) in ``minmax_sym`` normalisation, H and W
    multiples of 8."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 small: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are drawn from ``generator`` (a fresh one seeded with 0
        on ``device`` when None)."""
        super().__init__()
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        encoder = SmallEncoder if small else BasicEncoder
        self.fnet = encoder(output_dim=128 if small else 256,
                            norm_fn="instance", device=device)
        self.cnet = encoder(output_dim=hidden_dim + context_dim,
                            norm_fn="batch", device=device)
        update = SmallUpdateBlock if small else BasicUpdateBlock
        self.update_block = update(corr_levels * (2 * corr_radius + 1) ** 2,
                                   hidden_dim, context_dim, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(self, generator)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                only_last: bool = False
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """The upsampled flow (B, 2, H, W) of each step, or with
        ``only_last`` the last one alone. ``flow_init`` (B, 2, H/8, W/8)
        starts the coordinates away from the identity."""
        dtype = self.fnet.conv1.weight.dtype
        B = frame1.shape[0]
        fmaps = self.fnet(torch.cat([frame1, frame2]).to(dtype)).float()
        c = self.cnet(frame1.to(dtype))
        net = torch.tanh(c[:, :self.hidden_dim]).float()
        # the context feeds convs only: in the model's dtype, as they take it
        inp = torch.relu(c[:, self.hidden_dim:])

        levels = corr_pyramid(corr_volume(fmaps[:B], fmaps[B:]),
                              self.corr_levels)
        if only_last:
            levels = [lvl.to(dtype) for lvl in levels]
        pyramid = CorrPyramid(levels)
        H8, W8 = fmaps.shape[-2:]
        # channels-last like the convs' outputs the flow is concatenated with
        coords0 = coords_grid(H8, W8, device=fmaps.device).expand(
            B, 2, H8, W8).contiguous(memory_format=torch.channels_last)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        def step(net, coords1, with_mask):
            coords1 = coords1.detach()
            corr = pyramid.lookup(coords1, self.corr_radius)
            net, mask, delta = self.update_block(
                net, inp, corr.to(dtype), (coords1 - coords0).to(dtype),
                with_mask=with_mask)
            return net, coords1 + delta.float(), mask

        def upsample(coords1, mask):
            flow = coords1 - coords0
            return upflow8(flow) if mask is None \
                else convex_upsample(flow, mask.float())

        if only_last:
            for _ in range(iters - 1):
                net, coords1, _ = step(net, coords1, False)
            net, coords1, mask = step(net, coords1, True)
            return upsample(coords1, mask)
        flows = []
        for _ in range(iters):
            net, coords1, mask = step(net, coords1, True)
            flows.append(upsample(coords1, mask))
        return flows


class RAFT(RAFTBase):
    """The standard configuration: hidden 128, context 128, 4 levels, radius
    4."""


def built(model: RAFTBase, dtype: torch.dtype) -> RAFTBase:
    """``model`` ready to serve: in eval mode, its parameters in ``dtype``
    with channels_last strides, its norms' in float32 (flax keeps them so).
    The factories, the eval command's tiny model and the tests build so."""
    model.to(dtype=dtype, memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.float()
    return model.eval()


def raft(dtype: torch.dtype = torch.float32, device=None,
         generator: Optional[torch.Generator] = None) -> RAFT:
    """RAFT (hidden 128, context 128, 4 levels, radius 4) in eval mode. It
    builds on the CUDA card unless ``device`` names another
    (``device="cpu"``); with no device and no card it raises."""
    return built(RAFT(device=entry_device(device), generator=generator),
                 dtype)


def raft_small(dtype: torch.dtype = torch.float32, device=None,
               generator: Optional[torch.Generator] = None) -> RAFTBase:
    """RAFT-small (hidden 96, context 64, 4 levels, radius 3) in eval mode,
    on the card unless ``device`` names another, as ``raft``."""
    return built(RAFTBase(hidden_dim=96, context_dim=64, corr_levels=4,
                          corr_radius=3, small=True,
                          device=entry_device(device), generator=generator),
                 dtype)


def inference(flows: Union[torch.Tensor, List[torch.Tensor]]) -> List[Flow]:
    """The final flow prediction (B, 2, H, W), or the last of a list, ->
    one ``Flow`` (C, H, W) per image, on the flow's device."""
    final = flows[-1] if isinstance(flows, (list, tuple)) else flows
    return [Flow(f) for f in final.float()]
