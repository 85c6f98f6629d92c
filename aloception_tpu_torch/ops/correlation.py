"""RAFT's all-pairs correlation volume, its pyramid and the radius lookup
(counterpart of ``aloception_tpu/ops/correlation.py``), channels first.

The volume is one fp32 batched matmul. The lookup has ``corr_lookup``'s
semantics: per level, a (2r+1)^2 window of bilinear samples around each
query's coordinates, each of the four corners outside the level adding zero
(levels smaller than the window sample zeros, they do not clamp). It is a
gather: the levels are flattened into one buffer (``CorrPyramid``), so that
one gather reads every level's window. The JAX package's main path uses a
one-hot matmul recast of the same lookup, built for the TPU's matrix unit;
the two agree to rounding.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..aloscene.augmented import const


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, H*W, H, W): the float32 dot product of every
    pair of pixels over sqrt(C). Row n of the volume is the query pixel
    (n // W, n % W) of ``fmap1``."""
    B, C, H, W = fmap1.shape
    f1 = fmap1.float().reshape(B, C, H * W)
    f2 = fmap2.float().reshape(B, C, H * W)
    corr = torch.matmul(f1.transpose(1, 2), f2)
    return (corr / math.sqrt(C)).reshape(B, H * W, H, W)


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """The volume and num_levels - 1 average-pooled levels below it: 2x2
    windows of stride 2 over the last two dims, the odd last row or column
    dropped."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


class CorrPyramid:
    """The levels of a correlation pyramid, each (B, N, Hl, Wl), flattened
    into one (B, N, sum Hl*Wl) buffer in their dtype, with each level's
    scale, size and offset in it on the buffer's device."""

    def __init__(self, levels: Sequence[torch.Tensor]):
        B, N = levels[0].shape[:2]
        self.flat = torch.cat([lvl.reshape(B, N, -1) for lvl in levels], 2)
        sizes = [tuple(lvl.shape[2:]) for lvl in levels]
        starts = [0]
        for h, w in sizes[:-1]:
            starts.append(starts[-1] + h * w)
        # (4, L, 1, 1): each broadcasts over a level's (d, d) window
        consts = const([[2.0 ** -i for i in range(len(levels))],
                        [h for h, _ in sizes], [w for _, w in sizes],
                        starts], self.flat).reshape(4, -1, 1, 1)
        self.scale, self.h, self.w, self.start = consts
        # the two corners along an axis, broadcast over (corner, L, d, d)
        self.corners = const([0.0, 1.0], self.flat).view(2, 1, 1, 1)

    def lookup(self, coords: torch.Tensor, radius: int) -> torch.Tensor:
        """coords (B, 2, H, W): the level-0 (x, y) position of each query,
        H * W = N. Returns (B, L * (2r+1)^2, H, W) in float32 (channels-last
        strides). Channel l * d^2 + i * d + j of level l samples
        (x / 2^l + off[i], y / 2^l + off[j]), off = -r..r: the x offset on
        the outer axis, as the reference's converted ``convc1`` weights
        expect."""
        B, _, H, W = coords.shape
        off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=coords.device)
        # dims (B, N, corner, L, x offset, y offset): a corner axis of size
        # 2 for x's two corners, then for y's, ahead of the window
        c = coords.float().flatten(2)[..., None]                # (B, 2, N, 1)
        x = (c[:, 0] * self.scale[:, 0, 0])[:, :, None, :, None, None] \
            + off[:, None]                                      # (B, N, 1, L, d, 1)
        y = (c[:, 1] * self.scale[:, 0, 0])[:, :, None, :, None, None] \
            + off
        x0, y0 = torch.floor(x), torch.floor(y)

        def corners(v0, frac, size):
            """Both corners along one axis: their positions clamped into the
            level and their weights, zero outside it."""
            v = v0 + self.corners
            weight = torch.cat([1 - frac, frac], 2) * ((v >= 0) & (v < size))
            return torch.minimum(v.clamp(min=0), size - 1), weight

        xs, wx = corners(x0, x - x0, self.w)            # (B, N, 2, L, d, 1)
        ys, wy = corners(y0, y - y0, self.h)            # (B, N, 2, L, 1, d)
        rows = (self.start + ys * self.w).long()
        idx = rows[:, :, None] + xs.long()[:, :, :, None]       # (B, N, 2, 2, L, d, d)
        weight = wy[:, :, None] * wx[:, :, :, None]
        N = H * W
        vals = self.flat.gather(2, idx.reshape(B, N, -1)).view(B, N, 4, -1)
        out = (vals * weight.view(B, N, 4, -1)).sum(2)          # (B, N, L*d*d)
        return out.permute(0, 2, 1).reshape(B, -1, H, W)

