"""Times RAFT's correlation lookup on the card at the shapes and dtype pairs
its callers use (``chip_smoke.LOOKUP_CASES``), after holding the CUDA kernel
against the plain version on the same inputs: ``chip_smoke.corr_lookup_phase``
alone, without the rest of the smoke run. Device time per call from CUDA
graphs and the time per call of eager launches, both by CUDA events, for the
kernel (``CorrPyramid.lookup``, the operator), and eager for the plain
version as the model ran it before the kernel (``corr_lookup_torch``, then
the cast to the convolutions' dtype). Beside them the bound by bytes at the
card's 3.35 TB/s: the output counted in its dtype, and in float32 as the
benchmark's yardstick counts it
(``portbench/reference/raft_counting.py::lookup_bytes``, which the script
checks it agrees with). Prints the card's name and power limit, the kernel's
``ptxas`` report, then one JSON line.

    python3 scripts/corr_lookup_times.py

Needs a CUDA card.
"""

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from aloception_tpu_torch.ops.cuda import build  # noqa: E402
from portbench.reference.raft_counting import lookup_bytes  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("corr_lookup_times.py needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    result = cs.corr_lookup_phase(torch.device("cuda", 0))
    for name, r in result.items():
        pyramid_dtype = getattr(torch, r["pyramid"])
        want = lookup_bytes(B=r["B"], hw8=r["hw8"], levels=4,
                            radius=r["radius"], dtype=pyramid_dtype)
        got = r["yardstick_bound_ms"] * cs.HBM_BYTES_PER_S / 1e3
        if abs(got - want) > 1e-6 * want:
            raise AssertionError(f"{name}: the yardstick's bytes {want}, "
                                 f"chip_smoke's {got}")
    print(build.build_log("corr_lookup"))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
