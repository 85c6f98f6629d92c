"""Times one checkout's MSDA CUDA kernel at Deformable-DETR-R50's two call
sites (batch 16, 640 px, bfloat16), after holding it against the plain
version on the same inputs: device time per call from CUDA graphs, and the
time per call of eager launches, both by CUDA events. Prints the card's name
and power limit, then one JSON line.

    python3 scripts/msda_times.py [--tree DIR]

``--tree`` times the ``aloception_tpu_torch`` of another checkout (for
example an unpacked ``git archive`` of a parent commit) with this checkout's
inputs and timers (``chip_smoke.py``), so that runs of two trees in one
session on one card compare like with like. Needs a CUDA card.
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
    # this checkout's inputs and timers, the tree's kernel and plain version
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(tree))
    import torch
    import aloception_tpu_torch
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch

    if not torch.cuda.is_available():
        raise SystemExit("msda_times.py needs a CUDA card")
    package = pathlib.Path(aloception_tpu_torch.__file__).resolve()
    if tree not in package.parents:
        raise SystemExit(f"imported {package}, not the package of {tree}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    result = {"tree": str(tree)}
    for site, (B, Lq) in cs.TIMED_SHAPES.items():
        args = cs.msda_inputs(cs.LEVELS_640, B, Lq, cs.C, (0.0, 1.0),
                              torch.bfloat16, device)
        err = cs._gate(ms_deform_attn_cuda(*args), ms_deform_attn_torch(*args),
                       torch.bfloat16, site)[0]
        result[site] = {
            "B": B, "Lq": Lq, "max_abs_err": err,
            "graph_ms": cs.graph_ms(lambda: ms_deform_attn_cuda(*args)),
            "eager_ms": cs.cuda_ms(lambda: ms_deform_attn_cuda(*args))}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
