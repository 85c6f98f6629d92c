"""MSDeformAttn module (counterpart of
``aloception_tpu/models/deformable_detr/ms_deform_attn.py``).

Projects queries to per-head/level/point sampling offsets and attention
weights (softmax over level x point), samples the flattened multi-level value
map through the core op (``ops/ms_deform_attn.py``: the CUDA kernel on the
card) and projects the result. The offset bias is grid-initialised: head h
points at direction 2*pi*h/nH, scaled by the point index.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.ms_deform_attn import ms_deform_attn


def _grid_init_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, device=None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(
            d_model, n_heads * n_levels * n_points * 2, device=device)
        self.attention_weights = nn.Linear(
            d_model, n_heads * n_levels * n_points, device=device)
        self.value_proj = nn.Linear(d_model, d_model, device=device)
        self.output_proj = nn.Linear(d_model, d_model, device=device)
        self.reset_offsets()

    @torch.no_grad()
    def reset_offsets(self):
        """Zero the offset and weight kernels and grid-initialise the offset
        bias, so that at init every query samples the same pattern."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(_grid_init_bias(
            self.n_heads, self.n_levels, self.n_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor,
                input_spatial_shapes: Sequence[Tuple[int, int]],
                input_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """query: (B, Lq, C); reference_points: (B, Lq, L, 2) or (..., 4) in
        [0, 1]; input_flatten: (B, Lv, C); padding_mask: (B, Lv), 1 = padded."""
        B, Lq, _ = query.shape
        Lv = input_flatten.shape[1]
        nH, L, P = self.n_heads, self.n_levels, self.n_points

        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None] >= 0.5, 0.0)
        value = value.view(B, Lv, nH, -1)

        offsets = self.sampling_offsets(query).view(B, Lq, nH, L, P, 2)
        weights = self.attention_weights(query).view(B, Lq, nH, L * P)
        weights = weights.softmax(-1).view(B, Lq, nH, L, P)

        if reference_points.shape[-1] == 2:
            # offsets are in pixels of each level: normalise by its (W, H).
            # non_blocking: a blocking host-to-device copy would wait for
            # the stream to drain on every call
            normalizer = torch.tensor(
                [[w, h] for h, w in input_spatial_shapes],
                dtype=torch.float32).to(query.device, non_blocking=True)
            loc = reference_points[:, :, None, :, None, :] \
                + offsets / normalizer[None, None, None, :, None, :]
        elif reference_points.shape[-1] == 4:
            loc = reference_points[:, :, None, :, None, :2] \
                + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(value.contiguous(), input_spatial_shapes,
                             loc.to(value.dtype).contiguous(),
                             weights.to(value.dtype).contiguous())
        return self.output_proj(out)
