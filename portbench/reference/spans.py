"""The card's idle time put down to the program's own spans: the ``alo.*``
ranges that the program opens on the host (``utils/profiling.py::span``
in the port) and the intervals in which no kernel or copy ran on the card,
intersected exactly on the profiler's clock. Each idle microsecond goes to
the spans open on the host's main thread at that instant (the innermost
one, and through it those that enclose it), or to ``OUTSIDE``. The
arithmetic runs on plain ``(start, end)`` and ``(start, end, name)``
lists; ``idle_by_span`` reads them off a trace."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from portbench.reference.profiling import device_spans

PREFIX = "alo."
OUTSIDE = "outside"

Interval = Tuple[float, float]
Span = Tuple[float, float, str]
Piece = Tuple[float, float, Tuple[str, ...]]


def idle_intervals(busy: Iterable[Interval]) -> List[Interval]:
    """The gaps in the union of ``busy`` between its first start and its
    last end: where the card ran nothing."""
    gaps: List[Interval] = []
    end = None
    for s, e in sorted(busy):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def nest(spans: Iterable[Span]) -> List[Piece]:
    """Nested host spans as disjoint, time-ordered pieces, each with the
    path of the spans open over it, outermost first (its last name is the
    innermost span's). A span that outlasts its enclosing one (the clock's
    rounding) is cut at the enclosing one's end."""
    pieces: List[Piece] = []
    stack: List[Tuple[float, str]] = []     # (end, name), ends non-rising
    at = float("-inf")

    def path() -> Tuple[str, ...]:
        return tuple(name for _, name in stack)

    def close_until(t: float):
        nonlocal at
        while stack and stack[-1][0] <= t:
            if stack[-1][0] > at:
                pieces.append((at, stack[-1][0], path()))
                at = stack[-1][0]
            stack.pop()

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        close_until(s)
        if stack and s > at:
            pieces.append((at, s, path()))
        at = max(at, s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    close_until(float("inf"))
    return [p for p in pieces if p[1] > p[0]]


def assign(idle: List[Interval], pieces: List[Piece]) -> Dict:
    """Idle time by the path of spans over it, and ``OUTSIDE`` for idle
    time under no span (both lists time-ordered and disjoint)."""
    out: Dict = {OUTSIDE: 0.0}
    j = 0
    for s, e in idle:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            ps, pe, path = pieces[k]
            overlap = min(e, pe) - max(s, ps)
            if overlap > 0:
                out[path] = out.get(path, 0.0) + overlap
                covered += overlap
            k += 1
        out[OUTSIDE] += (e - s) - covered
    return out


def by_innermost(idle: Dict) -> Dict[str, float]:
    """``assign``'s idle time summed by the innermost span of each path."""
    out: Dict[str, float] = {}
    for path, us in idle.items():
        key = path if path == OUTSIDE else path[-1]
        out[key] = out.get(key, 0.0) + us
    return out


def host_spans(prof) -> List[Span]:
    """The trace's ``alo.*`` ranges on the host thread that opened the most
    of them (the program's main thread)."""
    from torch.autograd import DeviceType
    by_thread: Dict[int, List[Span]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith(PREFIX):
            by_thread.setdefault(ev.thread, []).append(
                (ev.time_range.start, ev.time_range.end, ev.name))
    if not by_thread:
        return []
    return max(by_thread.values(), key=len)


def idle_by_span(prof) -> Optional[Dict]:
    """Idle microseconds of the card over the trace's window (first device
    activity to last) by the path of ``alo.*`` spans open on the host, and
    ``OUTSIDE``; None where the trace holds no device activity or no span
    of the program."""
    spans = host_spans(prof)
    busy = device_spans(prof)
    if not spans or not busy:
        return None
    return assign(idle_intervals(busy), nest(spans))


def matches(name: str, names: Tuple[str, ...]) -> bool:
    """``name`` is one of ``names``, or begins with one ending in ``.``."""
    return any(name == n or (n.endswith(".") and name.startswith(n))
               for n in names)


def idle_ms_under(r, names: Iterable[str]) -> Optional[float]:
    """Idle milliseconds a traced unit under the spans ``names`` and the
    spans they enclose (a name ending in ``.`` stands for every span it
    begins)."""
    idle = idle_by_span(r["host_trace"])
    if idle is None:
        return None
    names = tuple(names)
    us = sum(v for path, v in idle.items() if path != OUTSIDE
             and any(matches(n, names) for n in path))
    return us / r["n_host_traced"] / 1e3
