"""The correlation lookup's share of its roofline: the least time of the
lookups that the program's counter (``CorrPyramid.lookups``) counted over
the traced batches, each ``raft_counting.lookup_bytes`` at the card's HBM
rate, over the device time of the kernels launched under the program's
span ``alo.raft.lookup`` in the same batches, in percent."""

from portbench.reference.counting import PEAKS
from portbench.reference.profiling import region_device_us
from portbench.reference.raft_counting import lookup_bytes

SPAN = "alo.raft.lookup"


def read(r):
    n, shape = r.get("raft_lookups"), r.get("lookup_shape")
    if not n or not shape:
        return None
    us = region_device_us(r["host_trace"], [SPAN])[SPAN]
    if us <= 0:
        return None
    least_s = n * lookup_bytes(**shape) / PEAKS["hbm_bytes_per_s"]
    return least_s * 1e6 / us * 100
