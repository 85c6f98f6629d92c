"""A configuration, a traffic mix, a cell, its limits and a per-layer
metric added as new files (and entries of BENCHMARK.json) in a copy of the
benchmark are found by name, with no file of the harness edited; a cell
whose limits are missing, empty or set for another precision is
refused."""

import json
import shutil

import pytest

from conftest import ROOT, TINY_CONFIG, TINY_FRAMES
from portbench import harness
from portbench.reference.compare import judged


def tiny_bench(tmp_path):
    """A copy of the benchmark with a tiny serving cell added as files,
    and the BENCHMARK.json that names it."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.read_json(base / "configs" / "detr_r50.json")
    cfg.update(TINY_CONFIG, name="detr_r50_tiny", num_classes=20)
    (base / "configs" / "detr_r50_tiny.json").write_text(json.dumps(cfg))
    traffic = dict(harness.read_json(base / "traffic" / "frames-b32.json"),
                   **TINY_FRAMES)
    traffic["batch_size"] = 3
    (base / "traffic" / "frames-tiny.json").write_text(json.dumps(traffic))
    (base / "metrics" / "images_seen.serve.py").write_text(
        "def read(r):\n    return float(r['window']['images'])\n")
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "detr_r50_tiny"})
    bench["workloads"].append({"name": "tiny-serve", "config":
                               "detr_r50_tiny", "traffic": "frames-tiny",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "images_per_s" == m["name"]:
            m["workloads"].append("tiny-serve")
    bench["per_layer"].append({
        "name": "images_seen.serve", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "Frame path",
        "moves": "images_per_s", "workloads": ["tiny-serve"]})
    limits = harness.read_json(base / "limits" / "detr-serve-b32.json")
    (base / "limits" / "tiny-serve.json").write_text(
        json.dumps(dict(limits, cell="tiny-serve")))
    return base, bench


def test_new_files_are_found(tmp_path):
    base, bench = tiny_bench(tmp_path)
    cell = harness.Cell(bench, "tiny-serve", base=base)
    assert cell.config["num_classes"] == 20
    assert cell.traffic["batch_size"] == 3
    assert set(cell.limits) == {"logits", "boxes", "served"}
    assert cell.control == "fp8"
    result = harness.run_cell(cell, 7, 0.3, True, "cpu", harness.now())
    seen = result["metrics"]["images_seen.serve"]["value"]
    assert seen > 0 and seen % 3 == 0
    assert result["correct"] is True


@pytest.mark.parametrize("fault", ["missing", "empty", "other_precision"])
def test_cell_without_sound_limits_is_refused(tmp_path, fault):
    base, bench = tiny_bench(tmp_path)
    path = base / "limits" / "tiny-serve.json"
    limits = harness.read_json(path)
    if fault == "missing":
        path.unlink()
    elif fault == "empty":
        path.write_text(json.dumps(dict(limits, numbers={})))
    else:
        path.write_text(json.dumps(dict(limits, precision="float32")))
    with pytest.raises((FileNotFoundError, ValueError)):
        harness.Cell(bench, "tiny-serve", base=base)


def test_nothing_compared_is_not_correct():
    assert judged({}, {})["correct"] is False
    assert judged({"logits": 0.0}, {})["correct"] is False
