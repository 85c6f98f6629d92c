"""Times one checkout's Hungarian CUDA kernel at the calls the training paths
launch (``chip_smoke.HUNGARIAN_TIMED``), after holding its assignment
against this checkout's plain version on the same inputs: device time per
call from CUDA graphs and the time per call of eager launches (CUDA events),
the bound for the inputs and the serial chain's us a step
(``chip_smoke.hungarian_times``). Prints the card's name and power limit,
then one JSON line.

    python3 scripts/hungarian_times.py [--tree DIR]

``--tree`` times the ``aloception_tpu_torch`` of another checkout (for
example an unpacked ``git archive`` of a parent commit) with this checkout's
inputs and timers, so that two trees timed on one card, one after the other,
compare like with like: run parent, change, change, parent. Needs a CUDA
card.
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=pathlib.Path, default=ROOT,
                        help="checkout whose kernel is timed")
    tree = parser.parse_args().tree.resolve()
    # this checkout's inputs, timers and plain version; the tree's kernel
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from aloception_tpu_torch.ops.hungarian import hungarian_torch
    for name in [m for m in sys.modules if m.startswith("aloception_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    import torch
    import aloception_tpu_torch
    from aloception_tpu_torch.ops.cuda import hungarian_cuda

    if not torch.cuda.is_available():
        raise SystemExit("hungarian_times.py needs a CUDA card")
    package = pathlib.Path(aloception_tpu_torch.__file__).resolve()
    if tree not in package.parents:
        raise SystemExit(f"imported {package}, not the package of {tree}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    result = {"tree": str(tree)}
    for shape in cs.HUNGARIAN_TIMED:
        M, nq, nt, choices = shape
        cost, n_valid = cs.hungarian_inputs(M, nq, nt, choices, False, seed=7)
        c_d, n_d = cost.to(device), n_valid.to(device)
        got = hungarian_cuda(c_d, n_d).cpu()
        if not torch.equal(got, hungarian_torch(cost, n_valid)):
            raise AssertionError(f"{cs.hungarian_tag(shape)}: the kernel's "
                                 "assignment is not the plain version's")
        row = cs.hungarian_times(lambda: hungarian_cuda(c_d, n_d), cost,
                                 n_valid)
        print(f"hungarian {cs.hungarian_tag(shape)}: {cs.hungarian_line(row)}")
        result[cs.hungarian_tag(shape)] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
