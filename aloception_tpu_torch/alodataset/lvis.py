"""LVIS v1 (counterpart of ``aloception_tpu/alodataset/lvis.py``): COCO-style
JSON (``lvis_v1_{train,val}.json``) with a large vocabulary; an image's path
is the last two parts of its ``coco_url`` (``{split}2017/<file>``) under
the dataset directory. Labels are the category ids, as in COCO."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels
from .base_dataset import BaseDataset, Split
from .coco_detection import _targets, poly_to_mask
from .mixins import SplitMixin


class LvisDataset(SplitMixin, BaseDataset):

    SPLIT_FOLDERS = {Split.TRAIN: "train2017", Split.VAL: "val2017"}

    def __init__(self, split: Split = Split.TRAIN, return_masks: bool = False,
                 sample: bool = False, **kwargs):
        self.split = split
        self.return_masks = return_masks
        super().__init__(name="lvis", sample=sample, **kwargs)
        if sample:
            self.items = list(range(6))
            self.labels_names = ["obj_a", "obj_b", "obj_c"]
            return
        tag = "train" if split == Split.TRAIN else "val"
        with open(os.path.join(self.dataset_dir,
                               f"lvis_v1_{tag}.json")) as f:
            lvis = json.load(f)
        cats = {c["id"]: c["name"] for c in lvis["categories"]}
        self.labels_names = ["N/A"] * (max(cats) + 1)
        for cid, name in cats.items():
            self.labels_names[cid] = name
        anns_by_img: Dict[int, List[dict]] = {}
        for a in lvis["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.imgs = {i["id"]: i for i in lvis["images"]}
        self.anns_by_img = anns_by_img
        self.items = sorted(self.imgs)

    def _img_path(self, info: dict) -> str:
        url = info.get("coco_url", "")
        suffix = "/".join(url.split("/")[-2:]) if url else info.get(
            "file_name", "")
        return os.path.join(self.dataset_dir, suffix)

    def _getitem_sample(self, idx: int) -> Frame:
        rng = np.random.RandomState(1300 + idx)
        frame = Frame(torch.from_numpy(
            rng.uniform(0, 255, (3, 96, 128)).astype(np.float32)))
        frame.append_boxes2d(BoundingBoxes2D(
            torch.tensor([[0.5, 0.5, 0.3, 0.3]]), boxes_format="xcyc",
            absolute=False, labels=Labels(torch.tensor([1.0]),
                                          labels_names=self.labels_names)))
        return frame

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        img_id = self.items[idx]
        frame = Frame(self._img_path(self.imgs[img_id]))
        H, W = frame.HW
        boxes, labels, masks = [], [], []
        for a in self.anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([(x + w / 2) / W, (y + h / 2) / H, w / W, h / H])
            labels.append(a["category_id"])
            if self.return_masks and "segmentation" in a:
                masks.append(poly_to_mask(a["segmentation"], H, W))
        return _targets(frame, boxes, labels,
                        masks if self.return_masks else None,
                        self.labels_names)
