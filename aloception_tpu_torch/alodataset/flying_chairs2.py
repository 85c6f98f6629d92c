"""FlyingChairs2 optical flow, the offline synthetic sample (counterpart of
``aloception_tpu/alodataset/flying_chairs2.py``).

``sample=True`` gives the JAX package's 8 deterministic pairs, made from the
same numpy seeds (2000 + idx): a 96x128 crop of a noise image and the crop
shifted by a drawn (dx, dy) in [-6, 6], the first frame carrying a
``flow_forward`` ``Flow`` of (dx, dy) everywhere and an all-zero occlusion
``Mask``. The pairs are copied as the JAX package makes them: the second
frame's content moves by -(dx, dy), so the label has the opposite sign to
the image shift (ROADMAP §C). FlyingChairs2 on disk waits in ROADMAP A10.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..aloscene import Flow, Frame, Mask
from ..aloscene.spatial import _cat_batched
from .base_dataset import LoaderFactory


class FlyingChairs2Dataset:
    """getitem -> Frame (T=2, C, H, W) of a pair of frames, float32,
    normalization "255"."""

    def __init__(self, sample: bool = False):
        if not sample:
            raise NotImplementedError(
                "FlyingChairs2 on disk is not ported yet (ROADMAP A10); pass "
                "sample=True")
        self.items = list(range(8))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Frame:
        """Deterministic synthetic pair ``idx``."""
        rng = np.random.RandomState(2000 + idx)
        H, W = 96, 128
        img0 = rng.uniform(0, 255, (3, H + 16, W + 16)).astype(np.float32)
        dx, dy = rng.randint(-6, 7), rng.randint(-6, 7)
        i0 = img0[:, 8:8 + H, 8:8 + W]
        i1 = img0[:, 8 + dy:8 + dy + H, 8 + dx:8 + dx + W]
        flow = torch.empty(2, H, W)
        flow[0], flow[1] = float(dx), float(dy)
        frame_0 = Frame(torch.from_numpy(i0.copy()), normalization="255")
        frame_1 = Frame(torch.from_numpy(i1.copy()), normalization="255")
        frame_0.append_flow(Flow(flow, occlusion=Mask(torch.zeros(1, H, W))),
                            "flow_forward")
        return _cat_batched([frame_0.temporal(), frame_1.temporal()],
                            axis_name="T")

    def train_loader(self, batch_size: int = 1, shuffle: bool = True,
                     seed: Optional[int] = None, drop_last: bool = True
                     ) -> LoaderFactory:
        """Re-iterable loader of lists of pairs, reshuffled each epoch,
        made in the calling thread."""
        return LoaderFactory(self, batch_size, 0, shuffle, seed, drop_last)
