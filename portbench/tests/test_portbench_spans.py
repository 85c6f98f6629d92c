"""``reference/spans.py`` on synthetic intervals: the card's idle time put
down to the innermost program span open on the host, exactly, and the
readers of the five span metrics on a stand-in trace."""

import random
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import ROOT
from portbench import harness
from portbench.reference.spans import (OUTSIDE, assign, by_innermost,
                                       idle_intervals, nest)

METRICS = ("prepare_idle_ms.train", "step_idle_ms.train",
           "criterion_device_ms.train", "frame_idle_ms.serve",
           "transformer_idle_ms.serve")


def split(busy, spans):
    return by_innermost(assign(idle_intervals(busy), nest(spans)))


def test_idle_between_busy_intervals():
    assert idle_intervals([(5, 7), (0, 2), (1, 3), (10, 11)]) == \
        [(3, 5), (7, 10)]
    assert idle_intervals([(0, 4), (1, 2)]) == []


def test_nested_spans_give_each_microsecond_to_the_innermost():
    spans = [(0, 100, "alo.step"), (10, 40, "alo.forward"),
             (20, 30, "alo.backbone"), (60, 90, "alo.fetch")]
    busy = [(0, 15), (25, 65), (95, 120)]   # idle: 15-25, 65-95
    got = split(busy, spans)
    assert got == {"alo.forward": 5, "alo.backbone": 5, "alo.fetch": 25,
                   "alo.step": 5, OUTSIDE: 0}
    pieces = nest(spans)
    assert [p[2] for p in pieces] == [
        ("alo.step",), ("alo.step", "alo.forward"),
        ("alo.step", "alo.forward", "alo.backbone"),
        ("alo.step", "alo.forward"), ("alo.step",),
        ("alo.step", "alo.fetch"), ("alo.step",)]


def test_idle_outside_every_span():
    got = split([(0, 10), (50, 60), (80, 90)],
                [(20, 30, "alo.a"), (55, 85, "alo.b")])
    assert got == {"alo.a": 10, "alo.b": 20, OUTSIDE: 30}


def test_a_child_that_outlasts_its_parent_is_cut():
    pieces = nest([(0, 10, "alo.p"), (5, 12, "alo.c"), (20, 30, "alo.q")])
    assert pieces == [(0, 5, ("alo.p",)), (5, 10, ("alo.p", "alo.c")),
                      (20, 30, ("alo.q",))]


def random_case(rng):
    """Properly nested integer spans and integer busy intervals."""
    spans = []

    def fill(lo, hi, depth):
        t = lo
        while t < hi - 2 and depth < 4:
            s = rng.randint(t, hi - 2)
            e = rng.randint(s + 1, hi)
            spans.append((s, e, f"alo.{depth}.{len(spans)}"))
            if rng.random() < 0.6:
                fill(s, e, depth + 1)
            t = e + rng.randint(0, 5)

    fill(0, 300, 0)
    busy = []
    for _ in range(rng.randint(1, 12)):
        s = rng.randint(-20, 320)
        busy.append((s, s + rng.randint(1, 40)))
    return spans, busy


@pytest.mark.parametrize("seed", range(40))
def test_split_matches_a_microsecond_walk(seed):
    spans, busy = random_case(random.Random(seed))
    got = split(busy, spans)
    lo, hi = min(s for s, _ in busy), max(e for _, e in busy)
    want = {OUTSIDE: 0}
    for t in range(lo, hi):
        if any(s <= t < e for s, e in busy):
            continue
        # the innermost: the latest to open, the shortest, the deepest
        open_ = [(sp[0], -sp[1], i, sp[2]) for i, sp in enumerate(spans)
                 if sp[0] <= t < sp[1]]
        name = max(open_)[3] if open_ else OUTSIDE
        want[name] = want.get(name, 0) + 1
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in want.items() if v}
    total = sum(e - s for s, e in idle_intervals(busy))
    assert sum(got.values()) == total


def stand_in_trace(spans, busy, thread=1):
    """A trace's ``events()`` as the readers see them: host ranges, device
    kernels, and one device op launched under each span (its self device
    time the span's length over 10)."""
    events = []
    for s, e, name in spans:
        span = SimpleNamespace(
            name=name, device_type=DeviceType.CPU, thread=thread,
            time_range=SimpleNamespace(start=s, end=e), cpu_parent=None,
            self_device_time_total=0)
        op = SimpleNamespace(
            name="aten::mm", device_type=DeviceType.CPU, thread=thread,
            time_range=SimpleNamespace(start=s, end=s + 1), cpu_parent=span,
            self_device_time_total=(e - s) / 10)
        events += [span, op]
    for s, e in busy:
        events.append(SimpleNamespace(
            name="kernel", device_type=DeviceType.CUDA,
            time_range=SimpleNamespace(start=s, end=e),
            is_user_annotation=False, self_device_time_total=0))
    return SimpleNamespace(events=lambda: events)


@pytest.fixture
def readers(bench):
    cell = harness.Cell(bench, "deformable-train-b8")
    return {m: cell.reader(m) for m in METRICS}


def test_span_readers(readers):
    spans = [(0, 1000, "alo.trainer.step"),
             (0, 200, "alo.trainer.prepare_batch"),
             (200, 250, "alo.trainer.to_device"),
             (250, 500, "alo.trainer.forward"),
             (300, 400, "alo.model.transformer"),
             (500, 600, "alo.trainer.criterion"),
             (600, 900, "alo.trainer.backward"),
             (1000, 1100, "alo.frame.init"),
             (1100, 1150, "alo.aug.resize"),
             (1150, 1200, "alo.spatial.batch_list")]
    busy = [(0, 100), (240, 350), (380, 700), (950, 1120), (1180, 1300)]
    r = {"host_trace": stand_in_trace(spans, busy), "n_host_traced": 2}
    got = {m: readers[m].read(r) for m in METRICS}
    assert got == {
        "prepare_idle_ms.train": (100 + 40) / 2 / 1e3,
        "step_idle_ms.train": (30 + 200) / 2 / 1e3,
        "criterion_device_ms.train": 10 / 2 / 1e3,
        "frame_idle_ms.serve": (30 + 30) / 2 / 1e3,
        "transformer_idle_ms.serve": 30 / 2 / 1e3}


def test_span_readers_without_spans(readers):
    """A program that opens no span (an older version of it) reads
    nothing, and raises nothing."""
    r = {"host_trace": stand_in_trace([(0, 10, "train_step")],
                                      [(0, 5), (8, 9)]),
         "n_host_traced": 2}
    assert {m: readers[m].read(r) for m in METRICS} == dict.fromkeys(
        METRICS)


def test_span_metrics_declared(bench):
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = declared[name]
        assert m["source"] == "program_span"
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()
