"""Device milliseconds a served batch of the kernels launched under the
program's span ``alo.raft.update``: RAFT's update block (motion encoder,
ConvGRU, flow head, the last step's mask head) and the coordinates' add,
over every refinement step of the batch."""

from portbench.reference.profiling import region_device_us

SPAN = "alo.raft.update"


def read(r):
    us = region_device_us(r["host_trace"], [SPAN])[SPAN]
    return us / r["n_host_traced"] / 1e3 if us > 0 else None
