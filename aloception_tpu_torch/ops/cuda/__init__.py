"""Hand-written CUDA kernels (sources in ``aloception_tpu_torch/csrc``), each
built at first use and bound with ctypes.

- ms_deform_attn_kernel.ms_deform_attn_cuda: MSDA forward; replaces the TPU
  kernel ``ms_deform_attn_pallas``.
- hungarian_kernel.hungarian_cuda: batched Hungarian matching; replaces the
  JAX package's on-device JV (XLA loops, no Pallas kernel).
"""

from .hungarian_kernel import hungarian_cuda  # noqa: F401
from .ms_deform_attn_kernel import ms_deform_attn_cuda  # noqa: F401
