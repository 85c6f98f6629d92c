"""Hand-written CUDA kernels (sources in ``aloception_tpu_torch/csrc``), each
built at first use and bound with ctypes.

- ms_deform_attn_kernel.ms_deform_attn_cuda: MSDA forward; replaces the TPU
  kernel ``ms_deform_attn_pallas``.
- hungarian_kernel.hungarian_cuda: batched Hungarian matching; replaces the
  JAX package's on-device JV (XLA loops, no Pallas kernel).
- corr_lookup_kernel.corr_lookup_cuda: RAFT's correlation lookup; replaces
  no TPU kernel (the JAX package's lookup is XLA).
"""

from .corr_lookup_kernel import corr_lookup_cuda  # noqa: F401
from .hungarian_kernel import hungarian_cuda  # noqa: F401
from .ms_deform_attn_kernel import ms_deform_attn_cuda  # noqa: F401
