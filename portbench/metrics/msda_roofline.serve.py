"""The deformable attention forward kernel's share of its roofline: the
least time of each call (``counting.msda_bound``, from the call's own
inputs as the traced batches handed them to the operation) summed over the
traced batches, over the device time of the kernels named
``msda_forward_kernel`` in the same batches, in percent."""

from portbench.reference.counting import msda_bound
from portbench.reference.profiling import rows_device_us


def read(r):
    calls = r.get("msda_calls") or []
    kernel_us = rows_device_us(r["host_trace"],
                               lambda k: "msda_forward_kernel" in k, True)
    if not calls or kernel_us <= 0:
        return None
    bound_ms = sum(msda_bound(shape, item, shapes, loc, w)["ms"]
                   for shape, item, shapes, loc, w in calls)
    return bound_ms * 1e3 / kernel_us * 100
