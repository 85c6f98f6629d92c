"""Run ``chip_smoke.py::parallel_phase`` alone on one CUDA card (TF32
off), after building the kernels: (a) two ranks on the one card over gloo
with CUDA tensors (Deformable-DETR-R50-refine at full width, 2 DDP steps
of bs1 a rank, then a sequence-parallel run of both rows, and RAFT one DDP
step), each against one process stepping the global bs2 batch; (b) a world
of one on NCCL (DDP, FSDP, bfloat16 FSDP) against the unwrapped steps; (c)
the 8-rank CPU dry run (``python -m aloception_tpu_torch.parallel.dryrun
8``). Named phases run instead: ``profiling`` (``cost_analysis`` and
``trace`` of the bf16 bs16 640-px Deformable-DETR-R50-refine forward),
``registry`` (``eval_on_coco --weights <registry name>``), ``tutorials``
(the port's tutorials 06, 08, 10 and 17).

    python3 scripts/parallel_phase.py [parallel] [profiling] [registry]
        [tutorials]

Prints the card's name and power limit first, the phases' lines, and last
their results as one JSON object.
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


def profiling(device):
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_detr_r50)
    m16 = deformable_detr_r50(
        num_classes=91, with_box_refine=True, dtype=torch.bfloat16,
        device=device, generator=torch.Generator(device=device).manual_seed(0))
    return chip_smoke.profiling_phase(m16, device)


def parallel(device):
    out, launches, backward, hungarian = chip_smoke.parallel_phase(device)
    return dict(out, msda_launches=launches, msda_backward_passes=backward,
                hungarian_launches=hungarian)


PHASES = {"parallel": parallel, "profiling": profiling,
          "registry": chip_smoke.registry_phase,
          "tutorials": lambda device: chip_smoke.tutorials_phase()}


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    unknown = set(names) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; "
                         f"choose from {sorted(PHASES)}")
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
    out = {}
    for name in names or ["parallel"]:
        t0 = time.perf_counter()
        out[name] = PHASES[name](device)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main(sys.argv[1:])
