"""The result line's shape, and a run that finds no card."""

import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, tiny
from portbench import harness


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(workload, trace, bench, capsys):
    cell = harness.Cell(bench, workload)
    result = harness.run_cell(cell, 2**31 + 11, 0.5, bool(trace), "cpu",
                              harness.now(), tiny(workload))
    harness.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert err.strip().splitlines()[-len(cell.limits)].startswith("check ")
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(line["metrics"]) == names


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "detr-serve-b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, bench, cuda):
    """Each cell at its full size for a short window: correct, and every
    metric reported (run on the card alone)."""
    cell = harness.Cell(bench, workload)
    for trace in (False, True):
        result = harness.run_cell(cell, 2**31 + 13, 2.0, trace, "cuda",
                                  harness.now())
        assert result["correct"], result["checks"]
        names = {m["name"] for m in (cell.per_layer if trace
                                     else cell.end_to_end)}
        assert set(result["metrics"]) == names
