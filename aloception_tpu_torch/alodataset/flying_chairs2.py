"""FlyingChairs2 optical flow (counterpart of
``aloception_tpu/alodataset/flying_chairs2.py``).

On disk: ``train/`` and ``val/`` folders of ``<id>-img_0.png``,
``<id>-img_1.png``, ``<id>-flow_01.flo`` and ``<id>-occ_01.png``; the ids
are the sorted prefixes of the ``*flow_01.flo`` names. The first frame
carries the forward flow with its occlusion ``Mask``.

``sample=True`` gives the JAX package's 8 deterministic pairs, made from the
same numpy seeds (2000 + idx): a 96x128 crop of a noise image and the crop
shifted by a drawn (dx, dy) in [-6, 6], the first frame carrying a
``flow_forward`` ``Flow`` of (dx, dy) everywhere and an all-zero occlusion
``Mask``. The pairs are copied as the JAX package makes them: the second
frame's content moves by -(dx, dy), so the label has the opposite sign to
the image shift (ROADMAP §C).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..aloscene import Flow, Frame, Mask
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split
from .mixins import SplitMixin


def _temporal_pair(frame_0: Frame, frame_1: Frame) -> Frame:
    """The two frames along T; the flow stays on t=0, as the per-step list
    [flow, None]."""
    return _cat_batched([frame_0.temporal(), frame_1.temporal()],
                        axis_name="T")


class FlyingChairs2Dataset(SplitMixin, BaseDataset):
    """getitem -> Frame (T=2, C, H, W), float32, normalization "255"."""

    SPLIT_FOLDERS = {Split.VAL: "val", Split.TRAIN: "train"}

    def __init__(self, split: Split = Split.TRAIN, sample: bool = False,
                 **kwargs):
        self.split = split
        super().__init__(name="FlyingChairs2", sample=sample, **kwargs)
        if sample:
            self.items = list(range(8))
            return
        self.dir_path = os.path.join(self.dataset_dir,
                                     self.get_split_folder())
        file_ids = sorted(f.split("-")[0] for f in os.listdir(self.dir_path)
                          if "flow_01.flo" in f)
        self.items = [{
            "image_0": os.path.join(self.dir_path, f"{fid}-img_0.png"),
            "image_1": os.path.join(self.dir_path, f"{fid}-img_1.png"),
            "flow": os.path.join(self.dir_path, f"{fid}-flow_01.flo"),
            "flow_occ": os.path.join(self.dir_path, f"{fid}-occ_01.png"),
        } for fid in file_ids]

    def _getitem_sample(self, idx: int) -> Frame:
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
        return _temporal_pair(frame_0, frame_1)

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        seq = self.items[idx]
        frame_0 = Frame(seq["image_0"])
        frame_1 = Frame(seq["image_1"])
        frame_0.append_flow(Flow(seq["flow"], occlusion=Mask(seq["flow_occ"])),
                            "flow_forward")
        return _temporal_pair(frame_0, frame_1)
