"""Readings of a ``torch.profiler`` trace and of CUDA's sync-debug mode,
frozen copies of ``chip_smoke.py``'s ``_device_us``, ``_trace``,
``_device_busy``, ``syncs_of``, ``_labelled`` and ``region_breakdown``'s
walk to a labelled region, with the breakdown the result line carries."""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch


def device_us(avg, self_only: bool = False) -> float:
    """Device microseconds of a profiler row (the attribute's name differs
    between PyTorch versions)."""
    prefix = "self_" if self_only else ""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(avg, name):
            return getattr(avg, name)
    raise AttributeError("profiler rows carry no device time")


def trace(fn: Callable, activities, n: int):
    """A profile of ``n`` calls of ``fn``, ending in a synchronise."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def device_events(prof) -> List:
    """The kernels and copies of a trace: its device events, without the
    ranges that host labels (``record_function``) mark on the device's
    timeline."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_spans(prof) -> List[Tuple[float, float]]:
    """Kernels and copies as (start us, end us) on the device clock."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in device_events(prof))


def device_busy(prof) -> Optional[Tuple[int, float, float]]:
    """(device activities, busy us, window us): the union of the device's
    intervals, and first start to last end; None without device activity."""
    spans = device_spans(prof)
    if not spans:
        return None
    busy, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    return len(spans), busy, spans[-1][1] - spans[0][0]


@contextlib.contextmanager
def sync_debug(caught: List[str]):
    """Collect the messages of CUDA operations that synchronise with the
    host while the block runs. The mode warns once, when it is set, that it
    is a prototype; that notice is raised outside and not counted."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
    caught.extend(str(w.message) for w in got
                  if "called a synchronizing CUDA operation" in str(w.message))


def labelled(fn: Callable, label: str) -> Callable:
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


def region_device_us(prof, regions: Iterable[str]) -> Dict[str, float]:
    """Device microseconds (self times of the ops that launched the
    kernels) under each labelled region: an op belongs to the innermost
    region among its callers."""
    from torch.autograd import DeviceType
    regions = set(regions)
    out = {r: 0.0 for r in regions}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        us = device_us(e, self_only=True)
        if not us:
            continue
        a = e
        while a is not None:
            if a.name in regions:
                out[a.name] += us
                break
            a = a.cpu_parent
    return out


def rows_device_us(prof, match: Callable[[str], bool],
                   self_only: bool) -> float:
    """Device microseconds of the profiler rows whose key ``match``es."""
    return sum(device_us(r, self_only) for r in prof.key_averages()
               if match(r.key))


def breakdown(prof, labels: Iterable[str], n: int = 10) -> Dict:
    """The device operations that took most time (kernels by self time,
    seconds), and the device's idle gaps summed by what the host was doing
    (the innermost of ``labels`` open on the host at the gap's middle, or
    the host op open there), seconds: at most ``n`` of each."""
    from torch.autograd import DeviceType
    labels = set(labels)
    ops: Dict[str, float] = {}
    for e in device_events(prof):
        if e.name not in labels:
            ops[e.name] = ops.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    rows = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    spans = device_spans(prof)
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    marked = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name in labels),
                    key=lambda t: t[0])
    tops = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.cpu_parent is None),
                  key=lambda t: t[0])
    gaps: Dict[str, float] = {}
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            mid = (s + end) / 2
            inside = [t for t in marked if t[0] <= mid <= t[1]]
            if inside:
                name = min(inside, key=lambda t: t[1] - t[0])[2]
            else:
                top = [t for t in tops if t[0] <= mid <= t[1]]
                name = top[0][2] if top else "host outside any op"
            gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e6
        end = max(end, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in rows],
            "idle_gaps": [[k, v] for k, v in idle]}
