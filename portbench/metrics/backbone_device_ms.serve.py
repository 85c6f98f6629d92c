"""Device milliseconds a batch of the kernels launched under the model's
backbone (a label the benchmark's forward hooks put around it)."""

from portbench.reference.profiling import region_device_us


def read(r):
    us = region_device_us(r["host_trace"], ["backbone"])["backbone"]
    return us / r["n_host_traced"] / 1e3 if us > 0 else None
