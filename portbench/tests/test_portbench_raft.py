"""The RAFT cell at tiny sizes on the CPU: a run end to end, its traffic,
the readers of its three span metrics on a stand-in trace, and the
yardstick's FLOPs and lookup bytes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from portbench import harness, program
from portbench.reference import raft_counting
from portbench.reference.models import raft as ref
from portbench.reference.nn import Precision
from portbench.reference.weights import make_weights
from test_portbench_spans import stand_in_trace

CELL = "raft-sintel-serve-b8"
TINY = {"traffic": {"batch_size": 2, "pool_batches": 2, "frame_hw": [61, 90],
                    "iters": 4, "shift_max": 8, "check_batches": 2,
                    "trace_batches": 2}}
METRICS = ("raft_update_device_ms.serve", "raft_lookup_roofline.serve",
           "raft_idle_ms.serve")


def config():
    return harness.read_json(harness.HERE / "configs" / "raft.json")


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end(trace, bench, capsys):
    cell = harness.Cell(bench, CELL)
    result = harness.run_cell(cell, 2**31 + 29, 0.5, bool(trace), "cpu",
                              harness.now(), TINY)
    harness.report(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    # flow_max is read (control.py prints it) but not judged
    assert set(line["checks"]) == {"epe", "flow_rms"}
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    if trace:
        # the CPU has no device trace: the span metrics read nothing
        assert set(line["metrics"]) == {"mfu.serve"}
        assert set(METRICS) <= names
    else:
        assert set(line["metrics"]) == names == {
            "images_per_s", "batch_p95_ms", "setup_s"}


def test_pool_shifts_the_second_frame():
    from portbench.drivers.serve_flow import flow_pool
    t = dict(harness.read_json(harness.HERE / "traffic"
                               / "pairs-sintel-b8.json"), **TINY["traffic"],
             noise=0)
    pool = flow_pool(t, 7, "cpu")
    assert len(pool) == 2 and all(len(s) == 2 for b in pool for s in b)
    again = flow_pool(t, 7, "cpu")
    for (a1, a2), (b1, b2) in zip(pool, again):
        assert all(torch.equal(x, y) for x, y in zip(a1 + a2, b1 + b2))
    first, second = pool[0][0][0], pool[0][1][0]
    assert first.shape == (61, 90, 3) and first.dtype == torch.uint8
    # the pixel at (x, y) of the first frame is at (x + dx, y + dy)
    hits = [(dx, dy) for dx in range(-8, 9) for dy in range(-8, 9)
            if torch.equal(first[max(0, -dy):61 - max(0, dy),
                                 max(0, -dx):90 - max(0, dx)],
                           second[max(0, dy):61 + min(0, dy),
                                  max(0, dx):90 + min(0, dx)])]
    assert len(hits) == 1


@pytest.fixture
def readers(bench):
    cell = harness.Cell(bench, CELL)
    return {m: cell.reader(m) for m in METRICS}


def test_span_readers(readers):
    spans = [(0, 100, "alo.frame.init"), (100, 200, "alo.raft.encoders"),
             (200, 300, "alo.raft.corr"), (300, 350, "alo.raft.lookup"),
             (350, 500, "alo.raft.update"), (500, 550, "alo.raft.lookup"),
             (550, 700, "alo.raft.update"), (700, 750, "alo.raft.upsample"),
             (750, 800, "alo.model.inference")]
    busy = [(0, 50), (120, 320), (340, 520), (560, 760)]
    shape = {"B": 2, "hw8": (8, 12), "levels": 4, "radius": 4,
             "dtype": torch.bfloat16}
    r = {"host_trace": stand_in_trace(spans, busy), "n_host_traced": 2,
         "raft_lookups": 2, "lookup_shape": shape}
    got = {m: readers[m].read(r) for m in METRICS}
    # a span's device op runs a tenth of the span's length
    assert got["raft_update_device_ms.serve"] == (15 + 15) / 2 / 1e3
    # idle 50-120 (20 of it under the encoders), 320-340 under a lookup,
    # 520-560 under a lookup (30) and an update (10)
    assert got["raft_idle_ms.serve"] == (20 + 20 + 30 + 10) / 2 / 1e3
    least_us = 2 * raft_counting.lookup_bytes(**shape) / 3.35e12 * 1e6
    assert got["raft_lookup_roofline.serve"] == \
        pytest.approx(least_us / (5 + 5) * 100)


def test_span_readers_without_spans(readers):
    """The parent program opens the Frame path's spans and no RAFT span,
    and counts no lookups: nothing is read, nothing raises."""
    r = {"host_trace": stand_in_trace([(0, 10, "alo.frame.init"),
                                       (10, 90, "aten::conv2d")],
                                      [(0, 5), (20, 30), (60, 70)]),
         "n_host_traced": 2, "raft_lookups": None,
         "lookup_shape": {"B": 2, "hw8": (8, 12), "levels": 4, "radius": 4,
                          "dtype": torch.bfloat16}}
    assert {m: readers[m].read(r) for m in METRICS} == dict.fromkeys(
        METRICS)


def test_metrics_declared(bench):
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "images_per_s"
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()
    for name in ("mfu.serve", "idle_share.serve"):
        assert CELL in declared[name]["workloads"]


def test_flops_per_pair_match_direct_counts():
    """The meta count at its padded size against the reference and the
    program, each counted on real tensors of that size."""
    cfg, hw, iters = config(), (61, 90), 3
    got = raft_counting.flops_per_pair(cfg, hw, iters)
    w = make_weights(ref.param_specs(cfg), 0, torch.float32, "cpu")
    image = torch.zeros(1, 3, 64, 96)
    counts = []
    for run in (lambda: ref.forward(w, image, image, cfg, Precision(), iters),
                lambda: program.build_model(cfg, w, torch.float32, "cpu",
                                            ref)(image, image, iters=iters,
                                                 only_last=True)):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            run()
        counts.append(counter.get_total_flops())
    assert got == counts[0] == counts[1]
    # the volume's matmul: two operations for each channel of each pair
    vol = 2 * (8 * 12) ** 2 * cfg["fnet_dim"]
    assert raft_counting.flops_per_pair(cfg, hw, 1) > vol


def test_lookup_bytes_by_hand():
    # 1 pair, a 4x6 map: levels 4x6 (24 values), 2x3 (6), 1x1 (1); radius 1
    # (3x3 windows, 16 corner values at most); bf16 pyramid
    outputs = 1 * 3 * 9 * 24 * 4
    reads = 24 * (16 + 6 + 1) * 2
    assert raft_counting.lookup_bytes(1, (4, 6), 3, 1, torch.bfloat16) == \
        outputs + reads
    assert raft_counting.level_sizes((55, 128), 4) == \
        [(55, 128), (27, 64), (13, 32), (6, 16)]
    # Sintel at 8 pairs: 73.0 MB of outputs, 44.6 MB of reads
    assert raft_counting.lookup_bytes(8, (55, 128), 4, 4,
                                      torch.bfloat16) == \
        8 * 4 * 81 * 7040 * 4 + 8 * 7040 * (100 * 3 + 96) * 2
