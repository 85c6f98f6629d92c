"""WoodScape fisheye dataset (counterpart of
``aloception_tpu/alodataset/woodscape.py``; reference:
alodataset/woodScape_dataset.py + woodScape_split_dataset.py).

On disk: ``rgb_images/*.png`` (the camera, FV/RV/MVL/MVR, in the name),
``box_2d_annotations/<stem>.txt`` (rows of class, ..., x1, y1, x2, y2,
comma or space separated) and ``semantic_annotations/gtLabels/<stem>.png``
(class indices, read as grey). ``cameras`` filters by view; ``fragment``
keeps a part of the sorted list (an int count or a float share in
[-1, 1]; negative takes it from the end); ``seg_classes`` selects the
one-hot segmentation planes, ``merge_classes`` merges them into one plane
named ``rename_merged``.

``sample=True`` gives the JAX package's 4 deterministic items, from the same
numpy seeds.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels, Mask
from ..runtime import decode
from .base_dataset import BaseDataset, Split


class WooDScapeDataset(BaseDataset):

    CLASSES = ("vehicles", "person", "bicycle", "traffic_light",
               "traffic_sign")
    CAMERAS = ("RV", "FV", "MVL", "MVR")
    LABELS = ("seg", "boxes_2d")
    SEG_CLASSES = ("void", "road", "lanemarks", "curb", "person", "rider",
                   "vehicles", "bicycle", "motorcycle", "traffic_sign")

    def __init__(self, labels: Optional[Sequence[str]] = ("boxes_2d",),
                 cameras: Optional[Sequence[str]] = None, fragment=1.0,
                 seg_classes: Optional[Sequence[str]] = None,
                 merge_classes: bool = False, rename_merged: str = "mix",
                 sample: bool = False, **kwargs):
        self.labels = list(labels or [])
        self.cameras = list(cameras) if cameras else list(self.CAMERAS)
        self.seg_classes = list(seg_classes) if seg_classes \
            else list(self.SEG_CLASSES)
        if not all(c in self.SEG_CLASSES for c in self.seg_classes):
            raise ValueError(f"invalid seg classes; supported: "
                             f"{self.SEG_CLASSES}")
        if not all(c in self.CAMERAS for c in self.cameras):
            raise ValueError(f"invalid cameras; supported: {self.CAMERAS}")
        self.merge_classes = merge_classes
        self.seg_classes_renamed = [rename_merged] if merge_classes \
            else self.seg_classes
        super().__init__(name="woodscape", sample=sample, **kwargs)
        if sample:
            self.items = list(range(4))
            return
        imgs = sorted(glob.glob(os.path.join(self.dataset_dir, "rgb_images",
                                             "*.png")))
        imgs = [p for p in imgs
                if any(c in os.path.basename(p) for c in self.cameras)]
        if isinstance(fragment, float):
            if not -1.0 <= fragment <= 1.0:
                raise ValueError("a float fragment must be in [-1, 1]")
            k = int(abs(fragment) * len(imgs))
        else:
            k = min(abs(int(fragment)), len(imgs))
        self.items = imgs[:k] if fragment >= 0 else imgs[len(imgs) - k:]

    def _getitem_sample(self, idx: int) -> Frame:
        rng = np.random.RandomState(7000 + idx)
        frame = Frame(torch.from_numpy(
            rng.uniform(0, 255, (3, 96, 128)).astype(np.float32)))
        frame.append_boxes2d(BoundingBoxes2D(
            torch.tensor([[0.4, 0.5, 0.2, 0.25]], dtype=torch.float32),
            "xcyc", False,
            labels=Labels(torch.tensor([0.0]), labels_names=self.CLASSES)))
        return frame

    def _seg_mask(self, stem: str) -> Optional[Mask]:
        """The class-index gtLabels PNG -> one-hot planes of the selected
        ``seg_classes``, merged into one when ``merge_classes``."""
        seg_path = os.path.join(self.dataset_dir, "semantic_annotations",
                                "gtLabels", stem + ".png")
        if not os.path.exists(seg_path):
            return None
        sem = decode(seg_path, "gray")[..., 0].numpy()
        planes = [(sem == self.SEG_CLASSES.index(name)).astype(np.float32)
                  for name in self.seg_classes]
        if self.merge_classes:
            planes = [np.clip(np.sum(planes, axis=0), 0, 1)]
        return Mask(torch.from_numpy(np.stack(planes)), labels=Labels(
            torch.arange(len(planes), dtype=torch.float32),
            labels_names=tuple(self.seg_classes_renamed)))

    def _boxes(self, stem: str, H: int, W: int) -> BoundingBoxes2D:
        ann = os.path.join(self.dataset_dir, "box_2d_annotations",
                           stem + ".txt")
        boxes, labs = [], []
        if os.path.exists(ann):
            with open(ann) as f:
                for line in f:
                    p = line.strip().split(",")
                    if len(p) < 6:
                        p = line.split()
                    name = p[0]
                    x1, y1, x2, y2 = map(float, p[-4:])
                    if name in self.CLASSES:
                        boxes.append([(x1 + x2) / 2 / W, (y1 + y2) / 2 / H,
                                      (x2 - x1) / W, (y2 - y1) / H])
                        labs.append(self.CLASSES.index(name))
        return BoundingBoxes2D(
            torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 4)),
            "xcyc", False,
            labels=Labels(torch.from_numpy(np.asarray(labs, np.float32)),
                          labels_names=self.CLASSES))

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        path = self.items[idx]
        frame = Frame(path)
        H, W = frame.HW
        stem = os.path.splitext(os.path.basename(path))[0]
        if "boxes_2d" in self.labels or "box_2d" in self.labels:
            frame.append_boxes2d(self._boxes(stem, H, W))
        if "segmentation" in self.labels or "seg" in self.labels:
            seg = self._seg_mask(stem)
            if seg is not None:
                frame.append_segmentation(seg)
        return frame


class WooDScapeSplitDataset(WooDScapeDataset):
    """train = the first 90 % of the sorted list, val = the last 10 %
    (woodScape_split_dataset.py:4), as signed fragments."""

    SPLIT_FRAGMENTS = {Split.TRAIN: 0.9, Split.VAL: -0.1}

    def __init__(self, split: Split = Split.TRAIN, **kwargs):
        self.split = split
        super().__init__(fragment=self.SPLIT_FRAGMENTS[split], **kwargs)
