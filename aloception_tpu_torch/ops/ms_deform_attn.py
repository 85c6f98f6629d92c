"""Multi-scale deformable attention sampling (MSDeformAttn core op).

Counterpart of ``aloception_tpu/ops/ms_deform_attn.py``. Semantics
(grid_sample align_corners=False, zero padding):

    out[b, q, h, :] = sum_{l, p} w[b, q, h, l, p] *
        bilinear(value_l[b, :, :, h, :], loc[b, q, h, l, p] * (W_l, H_l) - 0.5)

Shapes:
    value:              (B, Len_v, nH, C)   flattened levels, Len_v = sum H_l*W_l
    value_spatial_shapes: sequence of (H_l, W_l) ints
    sampling_locations: (B, Lq, nH, L, P, 2) in [0, 1] (x, y)
    attention_weights:  (B, Lq, nH, L, P)
Returns (B, Lq, nH * C) in value's dtype; sums are taken in float32.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from .cuda.ms_deform_attn_kernel import ms_deform_attn_cuda


def ms_deform_attn_torch(value: torch.Tensor,
                         value_spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``grid_sample`` per level over all batches,
    heads, queries and points, as the reference's
    ``ms_deform_attn_core_pytorch`` does. The parity target of the CUDA
    kernel, computed in float32."""
    B, _, nH, C = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    value_list = value.float().split([h * w for h, w in value_spatial_shapes],
                                     dim=1)
    grids = 2 * sampling_locations.float() - 1
    samples = []
    for lvl, (h, w) in enumerate(value_spatial_shapes):
        # (B, HW, nH, C) -> (B*nH, C, H, W)
        v = value_list[lvl].permute(0, 2, 3, 1).reshape(B * nH, C, h, w)
        # (B, Lq, nH, P, 2) -> (B*nH, Lq, P, 2)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # (B*nH, C, Lq, P)
    # (B, Lq, nH, L, P) -> (B*nH, 1, Lq, L*P)
    w = attention_weights.float().transpose(1, 2).reshape(B * nH, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * w).sum(-1)
    out = out.view(B, nH * C, Lq).transpose(1, 2)
    return out.to(value.dtype).contiguous()


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with a forward of ``forward`` (the CUDA kernel on the card) and
    the backward of the JAX package's ``_msda_pallas_bwd``
    (aloception_tpu/ops/ms_deform_attn.py:256): the gradient of the plain
    version, recomputed on the saved inputs, for value, loc and w. The JAX
    package has no backward kernel either (its Pallas backward was deleted
    after it failed on the hardware)."""

    @staticmethod
    def forward(ctx, forward: Callable, value: torch.Tensor,
                value_spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor) -> torch.Tensor:
        ctx.shapes = tuple((int(h), int(w)) for h, w in value_spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return forward(value, ctx.shapes, sampling_locations,
                       attention_weights)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        value, loc, w = ctx.saved_tensors
        needs = (ctx.needs_input_grad[1], ctx.needs_input_grad[3],
                 ctx.needs_input_grad[4])
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((value, loc, w), needs)]
        with torch.enable_grad():
            out = ms_deform_attn_torch(inputs[0], ctx.shapes, inputs[1],
                                       inputs[2])
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        ms_deform_attn_cuda.backward_passes += 1
        g_value, g_loc, g_w = (next(grads) if t.requires_grad else None
                               for t in inputs)
        return None, g_value, None, g_loc, g_w


def ms_deform_attn(value: torch.Tensor,
                   value_spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """A CPU tensor takes the plain version (plain autograd gives it
    gradients); any other device takes the CUDA kernel, which raises on what
    it cannot run, through ``MSDeformAttnFunction`` where an input requires
    grad. No fallback."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, value_spatial_shapes,
                                    sampling_locations, attention_weights)
    return ms_deform_attn_cuda(value, value_spatial_shapes, sampling_locations,
                               attention_weights)
