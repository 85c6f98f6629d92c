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

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

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


def ms_deform_attn_rounded(value: torch.Tensor,
                           value_spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor) -> torch.Tensor:
    """The same function in the arithmetic of the JAX package's block
    formulation (``ms_deform_attn_block``), whose vjp is its backward: the
    pixel coordinates ``loc * (W_l, H_l) - 0.5``, their fractions and the
    corner weights ``1 - f`` and ``f`` in value's dtype; the corner products,
    the samples and the sums in float32. In bfloat16 that rounds coordinates
    to a quarter or an eighth of a pixel at the widest level, which moves the
    gradients by a few percent (their location's by a third) from those of
    ``ms_deform_attn_torch``: this is what a bf16 train step's recompute
    backward takes the gradient of, as JAX's does. One ``embedding_bag`` a
    call: a bag per (b, q, h) of its L * P * 4 corner rows of value (zero
    weight outside), weighted by attention weight x corner weight; its
    gradient sums the value rows' contributions in float32."""
    B, len_v, nH, C = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dev = value.device
    # 32-bit row indices where they fit: a smaller sort in the backward
    index = torch.int32 if B * len_v * nH < 2**31 else torch.int64
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)
    h = torch.arange(nH, device=dev).view(1, 1, nH, 1)
    rows, coefs, start = [], [], 0
    for lvl, (hl, wl) in enumerate(value_spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]           # (B, Lq, nH, P, 2)
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        # each weight widened once, so that its gradient sums in float32
        ay_ = ((1 - fy).float(), fy.float())
        ax_ = ((1 - fx).float(), fx.float())
        a = attention_weights[:, :, :, lvl].float()
        for cy, ay in zip((y0, y0 + 1), ay_):
            for cx, ax in zip((x0, x0 + 1), ax_):
                ok = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
                s = start + (cy.clamp(0, hl - 1).long() * wl
                             + cx.clamp(0, wl - 1).long())
                rows.append(((b * len_v + s) * nH + h).to(index))
                coefs.append(a * (ay * ax * ok))
        start += hl * wl
    bags = B * Lq * nH
    out = F.embedding_bag(
        torch.stack(rows, -1).reshape(bags, -1),
        value.float().reshape(B * len_v * nH, C), mode="sum",
        per_sample_weights=torch.stack(coefs, -1).reshape(bags, -1))
    return out.view(B, Lq, nH * C).to(value.dtype)


OP_NAME = "aloception_tpu_torch::ms_deform_attn"


def _pairs(flat_shapes: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat_shapes[i]), int(flat_shapes[i + 1]))
                 for i in range(0, len(flat_shapes), 2))


# The operator ``torch.ops.aloception_tpu_torch.ms_deform_attn(value,
# spatial_shapes, sampling_locations, attention_weights)``, spatial_shapes
# flat as [H_0, W_0, H_1, W_1, ...]. It is what ``torch.export`` records
# and what an AOTInductor package calls at run time: its CUDA kernel is the
# hand-written one, its CPU kernel the plain version. Its inputs keep the
# strides they had when traced (contiguous at the model's call site), so a
# compiled package hands the kernel the layout it takes.
@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu",
                         tags=(torch.Tag.needs_exact_strides,))
def ms_deform_attn_op(value: torch.Tensor, spatial_shapes: List[int],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    return ms_deform_attn_torch(value, _pairs(spatial_shapes),
                                sampling_locations, attention_weights)


@ms_deform_attn_op.register_kernel("cuda")
def _ms_deform_attn_cuda_kernel(value, spatial_shapes, sampling_locations,
                                attention_weights):
    return ms_deform_attn_cuda(value, _pairs(spatial_shapes),
                               sampling_locations, attention_weights)


@ms_deform_attn_op.register_fake
def _ms_deform_attn_fake(value, spatial_shapes, sampling_locations,
                         attention_weights):
    B, _, nH, C = value.shape
    return value.new_empty((B, sampling_locations.shape[1], nH * C))


def _setup_context(ctx, inputs, output):
    value, spatial_shapes, sampling_locations, attention_weights = inputs
    ctx.shapes = _pairs(spatial_shapes)
    ctx.save_for_backward(value, sampling_locations, attention_weights)


def _backward(ctx, grad_out):
    """The backward of the JAX package's ``_msda_pallas_bwd``
    (aloception_tpu/ops/ms_deform_attn.py:256): the gradient of the plain
    version, recomputed on the saved inputs, for value, loc and w; in
    float32 that of ``ms_deform_attn_torch``, in a lower precision that of
    ``ms_deform_attn_rounded``, which computes as JAX's recompute does. The
    JAX package has no backward kernel either (its Pallas backward was
    deleted after it failed on the hardware). Each pass is counted in
    ``ms_deform_attn_cuda.backward_passes``."""
    value, loc, w = ctx.saved_tensors
    needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[2],
             ctx.needs_input_grad[3])
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip((value, loc, w), needs)]
    with torch.enable_grad():
        plain = ms_deform_attn_torch if value.dtype == torch.float32 \
            else ms_deform_attn_rounded
        out = plain(inputs[0], ctx.shapes, inputs[1], inputs[2])
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    ms_deform_attn_cuda.backward_passes += 1
    g_value, g_loc, g_w = (next(grads) if t.requires_grad else None
                           for t in inputs)
    return g_value, None, g_loc, g_w


ms_deform_attn_op.register_autograd(_backward, setup_context=_setup_context)


def msda_corners(spatial_shapes: Sequence[int],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor):
    """The four bilinear corners of every sampling point: a list of
    (cx, cy, ok), each (B, Lq, nH, L, P), ok where the corner falls inside
    its level and the point's attention weight is nonzero. The corners that
    the kernel reads; ``msda_fmas`` and the bound's byte count take them
    from here."""
    loc, w = sampling_locations, attention_weights
    shapes = _pairs(spatial_shapes)
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


def msda_fmas(value_shape: Sequence[int], spatial_shapes: Sequence[int],
              sampling_locations: torch.Tensor,
              attention_weights: torch.Tensor) -> int:
    """Multiply-adds of one call: one per channel of each corner of
    ``msda_corners`` (the attention weight folded into the corner weights).
    The count depends on the data; where the inputs carry none (fake or meta
    tensors, as when a compiler counts a traced graph), it is the most the
    shapes allow, four corners a point."""
    C = value_shape[-1]
    if is_fake(sampling_locations) or sampling_locations.is_meta:
        return 4 * attention_weights.numel() * C
    return C * sum(int(ok.sum()) for _, _, ok in msda_corners(
        spatial_shapes, sampling_locations, attention_weights))


@register_flop_formula(torch.ops.aloception_tpu_torch.ms_deform_attn,
                       get_raw=True)
def _ms_deform_attn_flops(value, spatial_shapes, sampling_locations,
                          attention_weights, *args, **kwargs) -> int:
    """Two operations per multiply-add, so that ``FlopCounterMode`` counts
    MSDA as the bound in ``chip_smoke.py`` does."""
    return 2 * msda_fmas(value.shape, spatial_shapes, sampling_locations,
                         attention_weights)


def ms_deform_attn(value: torch.Tensor,
                   value_spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The operator ``aloception_tpu_torch::ms_deform_attn``: a CPU tensor
    takes the plain version, a CUDA tensor the CUDA kernel, which raises on
    what it cannot run (no fallback); its gradient is the plain version's,
    recomputed (``_backward``)."""
    return ms_deform_attn_op(value,
                             [int(s) for hw in value_spatial_shapes
                              for s in hw],
                             sampling_locations, attention_weights)
