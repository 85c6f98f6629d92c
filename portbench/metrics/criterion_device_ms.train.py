"""Device milliseconds a train step of the kernels launched under the
program's span ``alo.trainer.criterion``: the criterion's forward with the
Hungarian matching (its backward runs on the autograd thread, under the
backward)."""

from portbench.reference.profiling import region_device_us

SPAN = "alo.trainer.criterion"


def read(r):
    us = region_device_us(r["host_trace"], [SPAN])[SPAN]
    return us / r["n_host_traced"] / 1e3 if us > 0 else None
