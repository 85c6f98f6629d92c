"""Wrapper of the hand-written batched Hungarian kernel (``csrc/hungarian.cu``).

It replaces the on-device Jonker-Volgenant solver of the JAX package,
``aloception_tpu/ops/hungarian.py:28`` (XLA loops, not a Pallas kernel). Its
plain version is ``ops.hungarian.hungarian_torch``. ``launch_plan`` sizes the
launch from the call's shapes; it is pure, cached, and reached by the CPU
tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .build import load_library

# what a block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
WARP = 32
BLOCK_WARPS = 4              # 128 threads a block; a warp solves a matrix
# the kernel's instances: columns a lane keeps in registers
# (hungarian.cu::kLaneColumns)
LANE_COLUMNS = (1, 2, 4, 8, 10, 16, 24, 32, 48, 64)
MAX_QUERIES = WARP * LANE_COLUMNS[-1]
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched.

    lane_columns: the kernel instance, columns (queries) a lane owns, the
        least of ``LANE_COLUMNS`` with 32 x it >= Nq; staged: the cost slice
        of each matrix copied into shared memory (else read from global
        memory); per_block: matrices (warps) a block of 128 threads;
        smem_bytes: the block's dynamic shared memory."""
    lane_columns: int
    staged: bool
    per_block: int
    smem_bytes: int


def slice_bytes(nq: int, nt: int, staged: bool) -> int:
    """Shared memory of one matrix (``hungarian.cu::slice_words``): the cost
    slice if staged, in its native layout, its rows of Nt targets Nt | 1
    words apart; then u, p and way."""
    words = (nt + 1) + 2 * (nq + 1) + (nq * (nt | 1) if staged else 0)
    return 4 * ((words + 3) & ~3)


@functools.lru_cache(maxsize=None)
def launch_plan(M: int, Nq: int, Nt: int, n_sms: int = H100_SMS
                ) -> LaunchPlan:
    """The plan of a call on M matrices of Nq queries x Nt targets, on a
    card of ``n_sms`` SMs. A matrix is staged where its slice fits a block;
    a block takes as few matrices as keep the grid within one wave of
    blocks (one a block up to ``n_sms`` matrices), at most four, and as many
    as fit. Raises ValueError where the kernel cannot take the call: Nt >
    Nq, or Nq above ``MAX_QUERIES``."""
    if Nt > Nq:
        raise ValueError(f"{Nt} targets for {Nq} queries: the assignment "
                         "needs Nt <= Nq")
    k = next((k for k in LANE_COLUMNS if WARP * k >= Nq), None)
    if k is None:
        raise ValueError(f"Nq={Nq} queries: the kernel takes at most "
                         f"{MAX_QUERIES} (a warp's lanes hold the columns)")
    staged = slice_bytes(Nq, Nt, True) <= MAX_SMEM_BYTES
    one = slice_bytes(Nq, Nt, staged)
    fit = min(BLOCK_WARPS, MAX_SMEM_BYTES // one)
    per_block = max(1, min(fit, -(-M // n_sms)))
    return LaunchPlan(k, staged, per_block, one * per_block)


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _forward_fn():
    fn = load_library("hungarian").hungarian_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hungarian_cuda(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """cost (M, Nq, Nt) float32, queries x targets; n_valid (M,) int32, the
    valid targets of each matrix (the first n_valid columns), read on the
    device: contiguous CUDA tensors on one device, Nt <= Nq <= MAX_QUERIES.
    Returns (M, Nt) int32: for each valid target the query matched to it, -1
    past n_valid. Launches one kernel on the current stream and never
    synchronises."""
    if cost.dim() != 3:
        raise ValueError(f"cost must be (M, Nq, Nt), got {tuple(cost.shape)}")
    M, Nq, Nt = cost.shape
    if n_valid.shape != (M,):
        raise ValueError(f"n_valid must be ({M},), got {tuple(n_valid.shape)}")
    if cost.dtype != torch.float32 or n_valid.dtype != torch.int32:
        raise TypeError("hungarian_cuda takes float32 costs and int32 "
                        f"n_valid, got {cost.dtype} and {n_valid.dtype}")
    if not (cost.is_cuda and n_valid.device == cost.device):
        raise ValueError("hungarian_cuda takes CUDA tensors on one device")
    if not (cost.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("hungarian_cuda takes contiguous tensors")
    index = cost.device.index
    plan = launch_plan(M, Nq, Nt, _n_sms(index))
    out = torch.empty((M, Nt), dtype=torch.int32, device=cost.device)
    if M == 0 or Nt == 0:
        return out
    forward = _forward_fn()
    args = (cost.data_ptr(), n_valid.data_ptr(), out.data_ptr(), M, Nq, Nt,
            plan.lane_columns, int(plan.staged), plan.per_block,
            plan.smem_bytes)
    if index == torch.cuda.current_device():
        err = forward(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = forward(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hungarian CUDA launch failed: cudaError {err}")
    hungarian_cuda.launches += 1
    return out


hungarian_cuda.launches = 0
