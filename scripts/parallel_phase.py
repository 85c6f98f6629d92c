"""Run ``chip_smoke.py::parallel_phase`` alone on one CUDA card (TF32
off), after building the kernels: (a) two ranks on the one card over gloo
with CUDA tensors (Deformable-DETR-R50-refine at full width, 2 DDP steps
of bs1 a rank, then a sequence-parallel run of both rows, and RAFT one DDP
step), each against one process stepping the global bs2 batch; (b) a world
of one on NCCL (DDP, FSDP) against the unwrapped steps; (c) the 8-rank CPU
dry run (``python -m aloception_tpu_torch.parallel.dryrun 8``).

    python3 scripts/parallel_phase.py

Prints the card's name and power limit first, the phase's lines, and last
its results as one JSON object.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from aloception_tpu_torch.ops.cuda.build import load_library
    print(chip_smoke._smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chip_smoke.KERNEL_SOURCES)) as pool:
        list(pool.map(load_library, chip_smoke.KERNEL_SOURCES))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    out, launches, backward, hungarian = chip_smoke.parallel_phase(device)
    out.update(msda_launches=launches, msda_backward_passes=backward,
               hungarian_launches=hungarian)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
