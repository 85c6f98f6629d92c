"""Wrapper of the hand-written MSDA forward kernel (``csrc/ms_deform_attn.cu``).

It replaces the TPU kernel ``ms_deform_attn_pallas``
(aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245). Its plain version is
``ops.ms_deform_attn.ms_deform_attn_torch``. ``launch_plan`` picks the
kernel's instance and shape of launch from the call's shapes and pointers; it
is pure, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from .build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = (16, 8, 4, 2)
UNROLLED_LP = (4, 4)         # the (L, P) instantiated with its points unrolled
MAX_LEVELS = 8
WARP = 32
RESIDENT_WARPS_PER_SM = 64   # Hopper: 2048 threads an SM
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched.

    vec_bytes: channel bytes a thread loads per corner and stores (16, 8, 4
        or 2), so that C * itemsize / vec_bytes threads, rounded up to a
        power of two, make the sub-group that owns a (b, q, h) triple's
        channels; split: sub-groups of a triple, each taking L / split
        levels, summed by warp shuffles; unrolled: the (L, P) = (4, 4)
        instance with its points unrolled, else the runtime-loop instance;
        share_points: in the unrolled instance, each point's corners
        computed by one thread of a sub-group of at least P threads and
        handed to the others by shuffles, else every thread computes every
        point."""
    vec_bytes: int
    split: int
    unrolled: bool
    share_points: bool


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def launch_plan(B: int, Lq: int, nH: int, C: int, L: int, P: int, len_v: int,
                itemsize: int, value_ptr: int = 0, loc_ptr: int = 0,
                w_ptr: int = 0, out_ptr: int = 0,
                n_sms: int = H100_SMS) -> LaunchPlan:
    """The plan of one call. Raises ValueError where the kernel cannot take
    the call: one image's value at or above 2**31 elements (offsets are
    32-bit), a head wider than 32 vectors of 16 bytes, a pointer not aligned
    to the element, more than 8 levels."""
    if len_v * nH * C >= 2 ** 31:
        raise ValueError(f"one image's value holds Len_v*nH*C = "
                         f"{len_v * nH * C} elements; the kernel's 32-bit "
                         "offsets take fewer than 2**31")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {L}")
    row_bytes = C * itemsize
    vec = next((v for v in VEC_BYTES if v >= itemsize and row_bytes % v == 0
                and value_ptr % v == 0 and out_ptr % v == 0), None)
    if vec is None or loc_ptr % itemsize or w_ptr % itemsize:
        raise ValueError("the kernel's tensors must be aligned to their "
                         f"{itemsize}-byte elements")
    group = row_bytes // vec
    gp = _pow2_ceil(group)
    if gp > WARP:
        raise ValueError(f"a head of C={C} channels takes {group} vectors; "
                         f"the kernel takes at most {WARP}")
    # widen a triple's threads by levels while the launch fills under two
    # waves of resident warps
    waves2 = 2 * n_sms * RESIDENT_WARPS_PER_SM
    split = 1
    while (2 * split <= L and gp * split * 2 <= WARP
           and B * Lq * nH * gp * split < waves2 * WARP):
        split *= 2
    unrolled = ((L, P) == UNROLLED_LP and UNROLLED_LP[0] % split == 0
                and loc_ptr % 16 == 0 and w_ptr % 16 == 0)
    return LaunchPlan(vec, split, unrolled,
                      share_points=unrolled and gp >= UNROLLED_LP[1])


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _forward_fn():
    fn = load_library("ms_deform_attn").msda_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_cuda(value: torch.Tensor,
                        value_spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """value (B, Len_v, nH, C), sampling_locations (B, Lq, nH, L, P, 2) in
    [0, 1] as (x, y), attention_weights (B, Lq, nH, L, P): contiguous CUDA
    tensors of one dtype, float32 or bfloat16. Returns (B, Lq, nH * C) in that
    dtype; the sums are taken in float32. ``plan`` overrides
    ``launch_plan``'s choice; the kernel refuses one it cannot run.

    This launcher has no gradient: the model reaches it through the
    operator ``aloception_tpu_torch::ms_deform_attn``
    (``ops.ms_deform_attn``), whose backward, the plain version's gradient,
    counts its passes in ``ms_deform_attn_cuda.backward_passes``. Each
    launch adds one to ``ms_deform_attn_cuda.launches`` and its plan to
    ``ms_deform_attn_cuda.plans``, keyed by (B, Lq, Len_v, dtype).
    """
    shapes = tuple((int(h), int(w)) for h, w in value_spatial_shapes)
    tensors = (value, sampling_locations, attention_weights)
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
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {L}")
    if value.dtype not in _DTYPES or any(t.dtype != value.dtype for t in tensors):
        raise TypeError("value, sampling_locations and attention_weights must "
                        "share one dtype, float32 or bfloat16; got "
                        f"{[t.dtype for t in tensors]}")
    if any(not t.is_cuda or t.device != value.device for t in tensors):
        raise ValueError("ms_deform_attn_cuda takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn_cuda takes contiguous tensors")

    out = torch.empty((B, Lq, nH * C), dtype=value.dtype, device=value.device)
    if plan is None:
        plan = launch_plan(B, Lq, nH, C, L, P, Len_v, value.element_size(),
                           value.data_ptr(), sampling_locations.data_ptr(),
                           attention_weights.data_ptr(), out.data_ptr(),
                           n_sms=_n_sms(value.device.index))
    flat_shapes = (ctypes.c_int64 * (2 * L))(*[s for hw in shapes for s in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _forward_fn()(value.data_ptr(), sampling_locations.data_ptr(),
                            attention_weights.data_ptr(), out.data_ptr(),
                            _DTYPES[value.dtype], B, Len_v, nH, C, Lq, L, P,
                            flat_shapes, plan.vec_bytes, plan.split,
                            int(plan.unrolled), int(plan.share_points), stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn CUDA launch failed: cudaError {err} "
                           f"(plan {plan})")
    ms_deform_attn_cuda.launches += 1
    ms_deform_attn_cuda.plans[(B, Lq, Len_v, str(value.dtype))] = plan
    return out


ms_deform_attn_cuda.launches = 0
ms_deform_attn_cuda.backward_passes = 0
ms_deform_attn_cuda.plans = {}
