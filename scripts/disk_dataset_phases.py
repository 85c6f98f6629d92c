"""Run the two dataset phases of ``chip_smoke.py`` alone, on one CUDA card
(TF32 off): ``flow_disk_phase`` (``train_on_chairs`` bs10 on a FlyingChairs2
directory at 384x512, ``eval_on_sintel`` on a Sintel directory at
436x1024, the card's EPE against the CPU's) and ``kitti_waymo_disk_phase``
(KITTI scene flow 2015, object and depth directories and a Waymo TFRecord
into RAFT, ``ApMetrics3D``, ``DepthMetrics`` and the 3-D projections, each
against the CPU). The directories are written from seeds into a temporary
root by ``aloception_tpu_torch/utils/flow_fixture.py``.

    python3 scripts/disk_dataset_phases.py

Prints the card's name and power limit first, each phase's lines, and
writes both phases' results to ``chiprun_out/disk_dataset_phases.json``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"flow_disk": chip_smoke.flow_disk_phase(device)}
    torch.cuda.empty_cache()
    out["kitti_waymo_disk"] = chip_smoke.kitti_waymo_disk_phase(device)
    out_dir = ROOT / "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir / "disk_dataset_phases.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"both phases: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
