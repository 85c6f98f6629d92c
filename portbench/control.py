"""Readings that a cell's limits are set from, on the card, in one
process: for each seed the program's numbers (a short window at the
cell's own load, or the set-up steps alone for training) and the
control's (the reference computed in the precision below the cell's), and
with ``--fault`` the program's with that fault planted. The benchmark's
own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 3] [--fault half_batch_train] [--no-control]

Prints one JSON line a seed: {"seed", "program", "control"}."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


def readings(cell, seed, seconds, fault=None, control=True,
             device="cuda", overrides=None):
    """{"program": numbers, "control": numbers or None} of one seed."""
    import torch
    driver = harness.make_driver(cell, seed, device, overrides)
    driver.setup()
    if fault:
        FAULTS[fault](driver)
    driver.measure(seconds, False)
    driver.release()
    out = {"program": driver.numbers("program"),
           "control": driver.numbers("control") if control else None}
    if hasattr(driver, "worst_leaves"):
        out["worst_leaves"] = driver.worst_leaves()
    del driver
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_dirs(ROOT)
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t = time.perf_counter()
        cell = harness.Cell(bench, args.workload)
        r = readings(cell, seed, args.seconds, args.fault,
                     not args.no_control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "seconds":
                          round(time.perf_counter() - t, 1), **r}),
              flush=True)


if __name__ == "__main__":
    main()
