"""Run ``chip_smoke.py::tracking_views_disk_phase`` alone on one CUDA card
(TF32 off), after building the kernels: CrowdHuman (12 train and 4 val
JPEGs, half at 1600x2400) through ``prepare()`` into
Deformable-DETR-R50-refine training with ``ObjectDetectorCallback`` and
the TensorBoard logger, MOT17 (8 frames at 1080x1920) through the
detector's Frame path and a Renderer grid, WoodScape (966x1280, one frame
a camera) and the KITTI scene's 3-D boxes through the views, each view on
the card against the CPU's. The directories are written from seeds into a
temporary root by ``aloception_tpu_torch/utils/tracking_fixture.py``.

    python3 scripts/tracking_views_phase.py

Prints the card's name and power limit first, the phase's lines, and
writes its results to ``chiprun_out/tracking_views_phase.json``.
"""

import json
import os
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
    out = chip_smoke.tracking_views_disk_phase(device)
    out_dir = ROOT / "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir / "tracking_views_phase.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"total: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
