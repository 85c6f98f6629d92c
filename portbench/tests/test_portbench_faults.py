"""The check decides: at a size a CPU test holds, the harness's run with
the timed path broken underneath (the look for a card skipped) comes out
not correct, and so does the control, the reference computed in the
precision below the cell's put in the program's place; a sound run comes
out correct. The limits are the cells' own."""

import pytest

from conftest import tiny
from portbench import harness
from portbench.control import readings
from portbench.reference.compare import judged

FAULTS = {"deformable-train-b8": ("state_unchanged", "half_batch_train"),
          "detr-serve-b32": ("half_batch_serve", "altered_answer"),
          "deformable-serve-b16": ("half_batch_serve", "altered_answer")}
CASES = [(w, f) for w, faults in FAULTS.items() for f in faults]


def run(bench, workload, fault=None, seed=5):
    cell = harness.Cell(bench, workload)
    r = readings(cell, seed, 0.3, fault, control=fault is None,
                 device="cpu", overrides=tiny(workload))
    return cell, r


@pytest.mark.parametrize("workload", list(FAULTS))
def test_sound_run_is_correct_and_control_is_not(bench, workload):
    cell, r = run(bench, workload)
    assert judged(r["program"], cell.limits)["correct"], r["program"]
    assert not judged(r["control"], cell.limits)["correct"], r["control"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(bench, workload, fault):
    cell, r = run(bench, workload, fault)
    assert not judged(r["program"], cell.limits)["correct"], r["program"]
