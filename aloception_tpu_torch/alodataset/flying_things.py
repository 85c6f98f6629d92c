"""FlyingThings3D subset and ChairsSDHom optical flow (counterpart of
``aloception_tpu/alodataset/flying_things.py``).

FlyingThings3D subset, ``train/`` and ``val/``: ``image_clean/left/%07d.png``
frames, ``flow/left/into_future/%07d.flo`` with its occlusion
``flow_occlusions/left/into_future/%07d.png``, and
``disparity/left/%07d.pfm``. A pair is two frames of consecutive ids; the
first carries the flow (``labels`` holding "flow"), and both frames their
disparities (holding "disparity": unsigned, ``camera_side="left"``; the JAX
package attaches the first frame's only, and its pair then fails to
concatenate: ROADMAP §C).

ChairsSDHom, ``data/train/`` and ``data/test/`` (VAL): ``t0/<stem>.png`` and
``t1/<stem>.png`` frames and ``flow/<stem>.flo``, else the first two
channels of ``flow/<stem>.pfm``.

``sample=True`` gives the JAX package's 6 deterministic pairs of each,
from the same numpy seeds (8000 + idx and 9000 + idx): a 96x128 crop of a
noise image and the crop shifted by a drawn (dx, dy) in [-4, 4], the first
frame carrying a ``flow_forward`` of (dx, dy) and an all-zero occlusion.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch

from ..aloscene import Disparity, Flow, Frame, Mask
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split
from .mixins import SplitMixin


def _pair(f0: Frame, f1: Frame) -> Frame:
    return _cat_batched([f0.temporal(), f1.temporal()], axis_name="T")


def _synthetic_pair(seed: int, H: int = 96, W: int = 128) -> Frame:
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (3, H + 8, W + 8)).astype(np.float32)
    dx, dy = rng.randint(-4, 5), rng.randint(-4, 5)
    f0 = Frame(torch.from_numpy(base[:, 4:4 + H, 4:4 + W].copy()))
    f1 = Frame(torch.from_numpy(
        base[:, 4 + dy:4 + dy + H, 4 + dx:4 + dx + W].copy()))
    flow = torch.empty(2, H, W)
    flow[0], flow[1] = float(dx), float(dy)
    f0.append_flow(Flow(flow, occlusion=Mask(torch.zeros(1, H, W))),
                   "flow_forward")
    return _pair(f0, f1)


class FlyingThings3DSubsetDataset(SplitMixin, BaseDataset):
    """getitem -> Frame (T=2, C, H, W), float32, normalization "255"."""

    SPLIT_FOLDERS = {Split.TRAIN: "train", Split.VAL: "val"}

    def __init__(self, split: Split = Split.TRAIN,
                 cameras: List[str] = ("left",),
                 labels: List[str] = ("flow",), backward: bool = False,
                 sample: bool = False, **kwargs):
        self.split = split
        self.cameras = list(cameras)
        self.labels = list(labels)
        self.backward = backward
        super().__init__(name="FlyingThings3DSubset", sample=sample, **kwargs)
        if sample:
            self.items = list(range(6))
            return
        self.base = os.path.join(self.dataset_dir, self.get_split_folder())
        imgs = sorted(glob.glob(os.path.join(self.base, "image_clean", "left",
                                             "*.png")))
        ids = [int(os.path.splitext(os.path.basename(p))[0]) for p in imgs]
        self.items = [(imgs[i], imgs[i + 1], ids[i])
                      for i in range(len(imgs) - 1) if ids[i + 1] == ids[i] + 1]

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return _synthetic_pair(8000 + idx)
        p0, p1, i0 = self.items[idx]
        f0, f1 = Frame(p0), Frame(p1)
        flow_path = os.path.join(self.base, "flow", "left", "into_future",
                                 f"{i0:07d}.flo")
        if "flow" in self.labels and os.path.exists(flow_path):
            occ_path = os.path.join(self.base, "flow_occlusions", "left",
                                    "into_future", f"{i0:07d}.png")
            occ = Mask(occ_path) if os.path.exists(occ_path) else None
            f0.append_flow(Flow(flow_path, occlusion=occ), "flow_forward")
        if "disparity" in self.labels:
            for f, i in ((f0, i0), (f1, i0 + 1)):
                disp_path = os.path.join(self.base, "disparity", "left",
                                         f"{i:07d}.pfm")
                if os.path.exists(disp_path):
                    f.append_disparity(Disparity(disp_path, png_negate=False,
                                                 camera_side="left"))
        return _pair(f0, f1)


class ChairsSDHomDataset(SplitMixin, BaseDataset):
    """Small-displacement chairs: getitem -> Frame (T=2, C, H, W)."""

    SPLIT_FOLDERS = {Split.TRAIN: "train", Split.VAL: "test"}

    def __init__(self, split: Split = Split.TRAIN, sample: bool = False,
                 **kwargs):
        self.split = split
        super().__init__(name="ChairsSDHom", sample=sample, **kwargs)
        if sample:
            self.items = list(range(6))
            return
        self.base = os.path.join(self.dataset_dir, "data",
                                 self.get_split_folder())
        self.items = [os.path.splitext(os.path.basename(p))[0] for p in
                      sorted(glob.glob(os.path.join(self.base, "t0", "*.png")))]

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return _synthetic_pair(9000 + idx)
        stem = self.items[idx]
        f0 = Frame(os.path.join(self.base, "t0", stem + ".png"))
        f1 = Frame(os.path.join(self.base, "t1", stem + ".png"))
        flo = os.path.join(self.base, "flow", stem + ".flo")
        pfm = os.path.join(self.base, "flow", stem + ".pfm")
        if os.path.exists(flo):
            f0.append_flow(Flow(flo), "flow_forward")
        elif os.path.exists(pfm):
            from ..aloscene.io.disparity import load_pfm
            f0.append_flow(Flow(load_pfm(pfm)[:2]), "flow_forward")
        return _pair(f0, f1)
