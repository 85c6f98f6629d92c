"""Wrapper of the hand-written MSDA forward kernel (``csrc/ms_deform_attn.cu``).

It replaces the TPU kernel ``ms_deform_attn_pallas``
(aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245). Its plain version is
``ops.ms_deform_attn.ms_deform_attn_torch``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _forward_fn():
    fn = load_library("ms_deform_attn").msda_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_cuda(value: torch.Tensor,
                        value_spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, Len_v, nH, C), sampling_locations (B, Lq, nH, L, P, 2) in
    [0, 1] as (x, y), attention_weights (B, Lq, nH, L, P): contiguous CUDA
    tensors of one dtype, float32 or bfloat16. Returns (B, Lq, nH * C) in that
    dtype; the sums are taken in float32.

    Forward only: inputs that require grad raise NotImplementedError.
    """
    shapes = tuple((int(h), int(w)) for h, w in value_spatial_shapes)
    tensors = (value, sampling_locations, attention_weights)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ms_deform_attn_cuda has no backward yet (ROADMAP B2); call it "
            "under torch.no_grad()")
    if value.dim() != 4:
        raise ValueError(f"value must be (B, Len_v, nH, C), got {tuple(value.shape)}")
    B, Len_v, nH, C = value.shape
    L = len(shapes)
    if sampling_locations.dim() != 6 or sampling_locations.shape[0] != B \
            or sampling_locations.shape[2:4] != (nH, L) \
            or sampling_locations.shape[5] != 2:
        raise ValueError(f"sampling_locations must be (B, Lq, {nH}, {L}, P, 2), "
                         f"got {tuple(sampling_locations.shape)}")
    Lq, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if attention_weights.shape != (B, Lq, nH, L, P):
        raise ValueError(f"attention_weights must be {(B, Lq, nH, L, P)}, got "
                         f"{tuple(attention_weights.shape)}")
    if sum(h * w for h, w in shapes) != Len_v:
        raise ValueError(f"level shapes {shapes} do not cover Len_v={Len_v}")
    if not 1 <= L <= 8:
        raise ValueError(f"the kernel takes 1 to 8 levels, got {L}")
    if value.dtype not in _DTYPES or any(t.dtype != value.dtype for t in tensors):
        raise TypeError("value, sampling_locations and attention_weights must "
                        "share one dtype, float32 or bfloat16; got "
                        f"{[t.dtype for t in tensors]}")
    if any(not t.is_cuda or t.device != value.device for t in tensors):
        raise ValueError("ms_deform_attn_cuda takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn_cuda takes contiguous tensors")

    out = torch.empty((B, Lq, nH * C), dtype=value.dtype, device=value.device)
    flat_shapes = (ctypes.c_int64 * (2 * L))(*[s for hw in shapes for s in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _forward_fn()(value.data_ptr(), sampling_locations.data_ptr(),
                            attention_weights.data_ptr(), out.data_ptr(),
                            _DTYPES[value.dtype], B, Len_v, nH, C, Lq, L, P,
                            flat_shapes, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn CUDA launch failed: cudaError {err}")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0
