"""MPI-Sintel optical flow, the offline synthetic sample (counterpart of
``aloception_tpu/alodataset/sintel.py``).

``sample=True`` gives the JAX package's 6 deterministic pairs (its sample at
``sequence_size=2``), made from the same numpy seeds: 96x128 noise frames,
the second shifted by one pixel from the first, which carries a
``flow_forward`` ``Flow`` of ones and an all-zero occlusion ``Mask``.
Sintel on disk waits in ROADMAP A10.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..aloscene import Flow, Frame, Mask
from ..aloscene.spatial import _cat_batched
from .base_dataset import LoaderFactory


class SintelFlowDataset:
    """getitem -> Frame (T, C, H, W) of a pair of frames, float32,
    normalization "255"."""

    def __init__(self, sample: bool = False):
        if not sample:
            raise NotImplementedError(
                "Sintel on disk is not ported yet (ROADMAP A10); pass "
                "sample=True")
        self.items = list(range(6))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Frame:
        """Deterministic synthetic pair ``idx``."""
        rng = np.random.RandomState(3000 + idx)
        H, W = 96, 128
        base = rng.uniform(0, 255, (3, H + 8, W + 8)).astype(np.float32)
        frames = []
        for t in range(2):
            f = Frame(torch.from_numpy(base[:, t:t + H, t:t + W].copy()),
                      normalization="255")
            if t == 0:
                f.append_flow(Flow(torch.ones(2, H, W), occlusion=Mask(
                    torch.zeros(1, H, W))), "flow_forward")
            frames.append(f.temporal())
        return _cat_batched(frames, axis_name="T")

    def train_loader(self, batch_size: int = 1, shuffle: bool = True,
                     seed: Optional[int] = None, drop_last: bool = True
                     ) -> LoaderFactory:
        """Re-iterable loader of lists of pairs, reshuffled each epoch,
        made in the calling thread."""
        return LoaderFactory(self, batch_size, 0, shuffle, seed, drop_last)
