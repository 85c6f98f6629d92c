"""RAFT's all-pairs correlation volume, its pyramid and the radius lookup
(counterpart of ``aloception_tpu/ops/correlation.py``), channels first.

The volume is one fp32 batched matmul. The lookup has ``corr_lookup``'s
semantics: per level, a (2r+1)^2 window of bilinear samples around each
query's coordinates, each of the four corners outside the level adding zero
(levels smaller than the window sample zeros, they do not clamp). The levels
are flattened into one buffer (``CorrPyramid``). The lookup is the operator
``aloception_tpu_torch::corr_lookup``: on the card the hand-written kernel
``csrc/corr_lookup.cu``, which reads each window once and writes the update
block's input in its dtype; on the CPU the plain version
``corr_lookup_torch``, one gather that reads every level's window. The JAX
package's main path uses a one-hot matmul recast of the same lookup, built
for the TPU's matrix unit; the three agree to rounding.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..aloscene.augmented import const
from .cuda.corr_lookup_kernel import corr_lookup_cuda


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


def corr_lookup_torch(flat: torch.Tensor, sizes: Sequence[Tuple[int, int]],
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version of the lookup, the parity target of the CUDA
    kernel. flat (B, N, sum Hl*Wl): the levels of ``sizes`` flattened, in
    their dtype; coords (B, 2, H, W): the level-0 (x, y) position of each
    query, H * W = N. Returns (B, L * (2r+1)^2, H, W) in float32
    (channels-last strides). Channel l * d^2 + i * d + j of level l samples
    (x / 2^l + off[i], y / 2^l + off[j]), off = -r..r: the x offset on the
    outer axis, as the reference's converted ``convc1`` weights expect. Each
    value is read in the pyramid's dtype and interpolated in float32."""
    N = flat.shape[1]
    starts = [0]
    for h, w in sizes[:-1]:
        starts.append(starts[-1] + h * w)
    # (4, L, 1, 1): each broadcasts over a level's (d, d) window
    scale, size_h, size_w, start = const(
        [[2.0 ** -i for i in range(len(sizes))], [h for h, _ in sizes],
         [w for _, w in sizes], starts], flat).reshape(4, -1, 1, 1)
    # the two corners along an axis, broadcast over (corner, L, d, d)
    corner = const([0.0, 1.0], flat).view(2, 1, 1, 1)
    B, _, H, W = coords.shape
    off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                       device=coords.device)
    # dims (B, N, corner, L, x offset, y offset): a corner axis of size
    # 2 for x's two corners, then for y's, ahead of the window
    c = coords.float().flatten(2)[..., None]                # (B, 2, N, 1)
    x = (c[:, 0] * scale[:, 0, 0])[:, :, None, :, None, None] \
        + off[:, None]                                      # (B, N, 1, L, d, 1)
    y = (c[:, 1] * scale[:, 0, 0])[:, :, None, :, None, None] \
        + off
    x0, y0 = torch.floor(x), torch.floor(y)

    def corners(v0, frac, size):
        """Both corners along one axis: their positions clamped into the
        level and their weights, zero outside it."""
        v = v0 + corner
        weight = torch.cat([1 - frac, frac], 2) * ((v >= 0) & (v < size))
        return torch.minimum(v.clamp(min=0), size - 1), weight

    xs, wx = corners(x0, x - x0, size_w)            # (B, N, 2, L, d, 1)
    ys, wy = corners(y0, y - y0, size_h)            # (B, N, 2, L, 1, d)
    rows = (start + ys * size_w).long()
    idx = rows[:, :, None] + xs.long()[:, :, :, None]       # (B, N, 2, 2, L, d, d)
    weight = wy[:, :, None] * wx[:, :, :, None]
    vals = flat.gather(2, idx.reshape(B, N, -1)).view(B, N, 4, -1)
    out = (vals * weight.view(B, N, 4, -1)).sum(2)          # (B, N, L*d*d)
    return out.view(B, H, W, -1).permute(0, 3, 1, 2)


OP_NAME = "aloception_tpu_torch::corr_lookup"


def _pairs(flat_sizes: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat_sizes[i]), int(flat_sizes[i + 1]))
                 for i in range(0, len(flat_sizes), 2))


def _out_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


# The operator ``torch.ops.aloception_tpu_torch.corr_lookup(flat, sizes,
# coords, radius, bf16)``, sizes flat as [H_0, W_0, H_1, W_1, ...], the
# output in bfloat16 where ``bf16``, else in float32. It is what
# ``torch.export`` records and what an AOTInductor package calls at run
# time: its CUDA kernel is the hand-written one, its CPU kernel the plain
# version with its float32 output cast. The output's dtype is a flag, not a
# ``torch.dtype`` argument: a CUDA AOTInductor package of torch 2.11 hands a
# custom operator's dtype argument over misread (float32 as float64). The
# kernels are registered on a ``Library``, not by ``custom_op``, whose
# kernels import ``torch._dynamo`` at their first call: seconds of a
# serving process's set-up.
_LIB = torch.library.Library("aloception_tpu_torch", "FRAGMENT")
_LIB.define("corr_lookup(Tensor flat, int[] sizes, Tensor coords, "
            "int radius, bool bf16) -> Tensor",
            tags=(torch.Tag.needs_exact_strides,))


def _corr_lookup_cpu_kernel(flat, sizes, coords, radius, bf16):
    return corr_lookup_torch(flat, _pairs(sizes), coords, radius).to(
        _out_dtype(bf16))


def _corr_lookup_cuda_kernel(flat, sizes, coords, radius, bf16):
    return corr_lookup_cuda(flat, _pairs(sizes), coords, radius,
                            _out_dtype(bf16))


def _corr_lookup_fake(flat, sizes, coords, radius, bf16):
    B, _, H, W = coords.shape
    return torch.empty((B, len(sizes) // 2 * (2 * radius + 1) ** 2, H, W),
                       dtype=_out_dtype(bf16), device=flat.device,
                       memory_format=torch.channels_last)


_LIB.impl("corr_lookup", _corr_lookup_cpu_kernel, "CPU")
_LIB.impl("corr_lookup", _corr_lookup_cuda_kernel, "CUDA")
torch.library.register_fake(OP_NAME, _corr_lookup_fake, lib=_LIB)


def _setup_context(ctx, inputs, output):
    flat, sizes, coords, radius, _ = inputs
    if coords.requires_grad:
        raise ValueError("corr_lookup gives the coordinates no gradient: "
                         "detach them (RAFT looks up detached coordinates)")
    ctx.sizes, ctx.radius = _pairs(sizes), radius
    ctx.save_for_backward(flat, coords)


def _backward(ctx, grad_out):
    """The pyramid's gradient: the plain version's, recomputed on the saved
    inputs (as ``ms_deform_attn``'s backward is), of its float32 output
    cast to the operator's dtype."""
    flat, coords = ctx.saved_tensors
    with torch.enable_grad():
        leaf = flat.detach().requires_grad_(True)
        out = corr_lookup_torch(leaf, ctx.sizes, coords, ctx.radius)
        grad, = torch.autograd.grad(out, leaf, grad_out.to(out.dtype))
    return grad, None, None, None, None


torch.library.register_autograd(OP_NAME, _backward,
                                setup_context=_setup_context, lib=_LIB)


def corr_lookup(flat: torch.Tensor, sizes: Sequence[Tuple[int, int]],
                coords: torch.Tensor, radius: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The operator ``aloception_tpu_torch::corr_lookup``: a CPU tensor takes
    the plain version, a CUDA tensor the CUDA kernel, which raises on what
    it cannot take (no fallback). Returns ``corr_lookup_torch``'s samples in
    ``dtype``, float32 or bfloat16; the pyramid's gradient is the plain
    version's, recomputed; coordinates that require a gradient are
    refused."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_lookup returns float32 or bfloat16, not "
                        f"{dtype}")
    return torch.ops.aloception_tpu_torch.corr_lookup(
        flat, [int(s) for hw in sizes for s in hw], coords, int(radius),
        dtype == torch.bfloat16)


class CorrPyramid:
    """The levels of a correlation pyramid, each (B, N, Hl, Wl), flattened
    into one (B, N, sum Hl*Wl) buffer in their dtype, with each level's
    size."""

    #: lookups called in the process, over every pyramid
    lookups = 0

    def __init__(self, levels: Sequence[torch.Tensor]):
        B, N = levels[0].shape[:2]
        self.flat = torch.cat([lvl.reshape(B, N, -1) for lvl in levels], 2)
        self.sizes = [tuple(lvl.shape[2:]) for lvl in levels]

    def lookup(self, coords: torch.Tensor, radius: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """coords (B, 2, H, W): the level-0 (x, y) position of each query,
        H * W = N. Returns ``corr_lookup_torch``'s (B, L * (2r+1)^2, H, W)
        in ``dtype`` (channels-last strides), through the operator
        ``corr_lookup``. Each call adds one to ``CorrPyramid.lookups``."""
        CorrPyramid.lookups += 1
        return corr_lookup(self.flat, self.sizes, coords, radius, dtype)
