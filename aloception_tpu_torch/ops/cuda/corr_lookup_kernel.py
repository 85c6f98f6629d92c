"""Wrapper of the hand-written RAFT correlation lookup kernel
(``csrc/corr_lookup.cu``).

It replaces no TPU kernel: the JAX package's lookup is XLA (a gather, and a
one-hot matmul on its RAFT's main path). Its plain version is
``ops.correlation.corr_lookup_torch``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8
# shared memory of one warp (one query): the block's default limit
# (corr_lookup.cu::kSmemBytes)
MAX_WARP_SMEM_BYTES = 48 * 1024


def warp_smem_bytes(levels: int, radius: int) -> int:
    """Shared memory of one query's warp: each level's table of 2(2r+1)
    taps of 16 bytes and its (2r+2)^2 float32 patch."""
    d = 2 * radius + 1
    return levels * (2 * d * 16 + (d + 1) ** 2 * 4)


@functools.lru_cache(maxsize=None)
def _lookup_fn():
    fn = load_library("corr_lookup").corr_lookup
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def corr_lookup_cuda(flat: torch.Tensor, sizes: Sequence[Tuple[int, int]],
                     coords: torch.Tensor, radius: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flat (B, N, sum Hl*Wl): the pyramid's levels flattened, a contiguous
    CUDA tensor in float32 or bfloat16; sizes the levels' (Hl, Wl);
    coords (B, 2, H, W) float32 on the same card, any strides, N = H * W.
    Returns (B, L*(2r+1)^2, H, W) in ``dtype`` (float32 or bfloat16; a
    bfloat16 pyramid into bfloat16 only: no caller asks for more) with
    channels-last strides: ``corr_lookup_torch``'s samples, summed in
    float32 and rounded once to ``dtype``.

    This launcher has no gradient: the model reaches it through the
    operator ``aloception_tpu_torch::corr_lookup`` (``ops.correlation``),
    whose backward is the plain version's gradient. Each launch adds one to
    ``corr_lookup_cuda.launches``."""
    sizes = tuple((int(h), int(w)) for h, w in sizes)
    L = len(sizes)
    if flat.dim() != 3:
        raise ValueError(f"flat must be (B, N, S), got {tuple(flat.shape)}")
    B, N, S = flat.shape
    if coords.dim() != 4 or coords.shape[:2] != (B, 2) \
            or coords.shape[2] * coords.shape[3] != N:
        raise ValueError(f"coords must be ({B}, 2, H, W) with H * W = {N}, "
                         f"got {tuple(coords.shape)}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {L}")
    if any(h < 1 or w < 1 for h, w in sizes) \
            or sum(h * w for h, w in sizes) != S:
        raise ValueError(f"level sizes {sizes} do not cover a row of {S}")
    if S >= 2 ** 31:
        raise ValueError(f"a pyramid row of {S} values; the kernel's 32-bit "
                         "offsets within a row take fewer than 2**31")
    if radius < 0 or warp_smem_bytes(L, radius) > MAX_WARP_SMEM_BYTES:
        raise ValueError(f"radius {radius} at {L} levels: the kernel takes a "
                         f"radius >= 0 whose patches fit "
                         f"{MAX_WARP_SMEM_BYTES} bytes of shared memory")
    if flat.dtype not in _DTYPES or dtype not in _DTYPES \
            or coords.dtype != torch.float32:
        raise TypeError("the kernel takes a float32 or bfloat16 pyramid and "
                        "output and float32 coordinates; got "
                        f"{flat.dtype}, {dtype}, {coords.dtype}")
    if flat.dtype == torch.bfloat16 and dtype == torch.float32:
        raise TypeError("the kernel looks a bfloat16 pyramid up into "
                        "bfloat16 only, as RAFT serves it")
    if not flat.is_contiguous():
        raise ValueError("corr_lookup_cuda takes a contiguous pyramid")
    if not flat.is_cuda or coords.device != flat.device:
        raise ValueError("corr_lookup_cuda takes CUDA tensors on one device")

    H, W = coords.shape[2:]
    out = torch.empty((B, L * (2 * radius + 1) ** 2, H, W), dtype=dtype,
                      device=flat.device, memory_format=torch.channels_last)
    strides = (ctypes.c_int64 * 4)(*coords.stride())
    flat_sizes = (ctypes.c_int64 * (2 * L))(*[s for hw in sizes for s in hw])
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lookup_fn()(flat.data_ptr(), coords.data_ptr(), out.data_ptr(),
                           _DTYPES[flat.dtype], _DTYPES[dtype], B, H, W,
                           strides, L, flat_sizes, radius, stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup CUDA launch failed: cudaError {err}")
    corr_lookup_cuda.launches += 1
    return out


corr_lookup_cuda.launches = 0
