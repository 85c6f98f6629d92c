"""Device milliseconds a train step under the optimizer's step
(``Optimizer.step#...``), its children included."""

from portbench.reference.profiling import rows_device_us


def read(r):
    us = rows_device_us(r["host_trace"],
                        lambda k: k.startswith("Optimizer.step#"), False)
    return us / r["n_host_traced"] / 1e3 if us > 0 else None
