"""Wrapper of the hand-written batched Hungarian kernel (``csrc/hungarian.cu``).

It replaces the on-device Jonker-Volgenant solver of the JAX package,
``aloception_tpu/ops/hungarian.py:28`` (XLA loops, not a Pallas kernel). Its
plain version is ``ops.hungarian.hungarian_torch``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

# what a block may use on Hopper, with room for the static part
MAX_SMEM_BYTES = 227 * 1024


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("hungarian")
    lib.hungarian_forward.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.hungarian_forward.restype = ctypes.c_int
    lib.hungarian_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.hungarian_smem_bytes.restype = ctypes.c_longlong
    return lib


def hungarian_cuda(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """cost (M, Nq, Nt) float32, queries x targets; n_valid (M,) int32, the
    valid targets of each matrix (the first n_valid columns), read on the
    device: contiguous CUDA tensors on one device, Nt <= Nq. Returns (M, Nt)
    int32: for each valid target the query matched to it, -1 past n_valid.
    Launches one kernel on the current stream and never synchronises."""
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
    if Nt > Nq:
        raise ValueError(f"{Nt} targets for {Nq} queries: the assignment "
                         "needs Nt <= Nq")
    out = torch.empty((M, Nt), dtype=torch.int32, device=cost.device)
    if M == 0 or Nt == 0:
        return out
    lib = _lib()
    staged = int(lib.hungarian_smem_bytes(Nq, Nt, 1) <= MAX_SMEM_BYTES)
    if lib.hungarian_smem_bytes(Nq, Nt, staged) > MAX_SMEM_BYTES:
        raise ValueError(f"Nq={Nq} columns do not fit the kernel's shared "
                         "memory")
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hungarian_forward(cost.data_ptr(), n_valid.data_ptr(),
                                    out.data_ptr(), M, Nq, Nt, staged, stream)
    if err != 0:
        raise RuntimeError(f"hungarian CUDA launch failed: cudaError {err}")
    hungarian_cuda.launches += 1
    return out


hungarian_cuda.launches = 0
