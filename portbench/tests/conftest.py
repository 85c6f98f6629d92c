"""The benchmark's CPU tests: the harness driven at tiny sizes, on the
CPU, with the kernels' plain versions. ``python -m pytest portbench/tests``
from the repository's root."""

import sys
from pathlib import Path

import pytest
import torch

# One host thread a test process: the tiny CPU runs are held to the cells'
# limits, and PyTorch's CPU reductions split over threads sum in another
# order (several test processes share the host besides).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# widths a CPU test can hold; every other key is the cell's own
TINY_CONFIG = {"hidden_dim": 32, "nheads": 4, "enc_layers": 2,
               "dec_layers": 2, "dim_feedforward": 64, "num_queries": 20,
               "stage_sizes": [1, 1, 1, 1], "n_points": 2}
TINY_FRAMES = {"batch_size": 2, "pool_batches": 2, "frame_h": [48, 72],
               "frame_w": [64, 96], "long_side": 128, "pad_to": [128, 128],
               "check_batches": 2, "trace_batches": 2}
TINY_TRAFFIC = {
    "deformable-train-b8": {"batch_size": 2, "image_size": [64, 96],
                            "pool_batches": 4, "trace_steps": 2,
                            "objects": {"min": 1, "max": 5, "mean": 2}},
    "detr-serve-b32": TINY_FRAMES,
    "deformable-serve-b16": TINY_FRAMES,
}
CELLS = tuple(TINY_TRAFFIC)


def tiny(workload):
    return {"config": TINY_CONFIG, "traffic": TINY_TRAFFIC[workload]}


@pytest.fixture
def bench():
    from portbench import harness
    return harness.read_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def cuda():
    """Tests marked ``cuda`` need the card; without one they skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
