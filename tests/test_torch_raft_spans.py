"""RAFT's named spans (``utils/profiling.py::span``) and its counters of
lookups and update steps on the CPU: the ``alo.raft.*`` ranges of one
forward under ``torch.profiler``, nothing built with no profiler, and no
span in an exported graph."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aloception_tpu_torch.export import RAFTExporter
from aloception_tpu_torch.models.raft import RAFTBase, built, inference
from aloception_tpu_torch.ops.correlation import CorrPyramid

from test_torch_spans import BENCHMARK_LABELS, enclosing_span, spans_of

ITERS = 3


@pytest.fixture(scope="module")
def tiny():
    return built(RAFTBase(hidden_dim=32, context_dim=32, corr_levels=2,
                          corr_radius=2, device="cpu"), torch.float32)


def frames():
    g = torch.Generator().manual_seed(0)
    return [torch.rand(2, 3, 32, 48, generator=g) * 2 - 1 for _ in range(2)]


@pytest.mark.parametrize("only_last, upsamples", [(True, 1), (False, ITERS)])
def test_forward_spans(tiny, only_last, upsamples):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            flows = tiny(*frames(), iters=ITERS, only_last=only_last)
        inference(flows)
    spans = spans_of(prof)
    names = [e.name for e in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "alo.raft.encoders": 1, "alo.raft.corr": 1,
        "alo.raft.lookup": ITERS, "alo.raft.update": ITERS,
        "alo.raft.upsample": upsamples, "alo.model.inference": 1}
    assert all(enclosing_span(e) is None for e in spans)
    for e in spans:
        a = e.cpu_parent
        while a is not None:
            assert a.name not in BENCHMARK_LABELS
            a = a.cpu_parent
    # each step's lookup ends before its update opens
    steps = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in spans if e.name in ("alo.raft.lookup",
                                                "alo.raft.update"))
    assert [n for _, _, n in steps] == ["alo.raft.lookup",
                                        "alo.raft.update"] * ITERS
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))


def test_counters_advance_by_the_steps_run(tiny):
    lookups, steps = CorrPyramid.lookups, RAFTBase.update_steps
    with torch.no_grad():
        tiny(*frames(), iters=ITERS, only_last=True)
    assert CorrPyramid.lookups - lookups == ITERS
    assert RAFTBase.update_steps - steps == ITERS


def test_no_profiler_builds_no_record_function(tiny, monkeypatch):
    def refuse(name):
        raise AssertionError("a span built a record_function with no "
                             "profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.no_grad():
        inference(tiny(*frames(), iters=ITERS, only_last=True))


def test_exported_raft_holds_no_span(tiny):
    exporter = RAFTExporter(tiny, input_shape=(32, 48), iters=2)
    with profile(activities=[ProfilerActivity.CPU]):
        exported, _, _ = exporter.export_program()
    targets = {str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"}
    assert "aten.conv2d.default" in targets
    assert not any("record_function" in t or "profiler" in t
                   for t in targets), targets
