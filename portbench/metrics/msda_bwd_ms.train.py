"""Device milliseconds a train step under the deformable attention
operator's autograd node (torch.library names it after the operator),
its children included."""

from portbench.reference.profiling import rows_device_us

NODE = "GeneratedBackwardFor_aloception_tpu_torch_ms_deform_attn"


def read(r):
    us = rows_device_us(r["host_trace"], lambda k: k.startswith(NODE), False)
    return us / r["n_host_traced"] / 1e3 if us > 0 else None
