"""Run one cell of the port's benchmark on the CUDA card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
Without a CUDA card, with fewer cards than the cell asks for, or with the
JAX stack loaded once the window has closed, it exits non-zero and prints
no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.cache_dirs(ROOT)
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
              f"{cell.entry['chips']}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the JAX stack is loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
