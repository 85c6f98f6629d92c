"""COCO panoptic, the offline synthetic sample (counterpart of
``aloception_tpu/alodataset/coco_panoptic.py``).

A panoptic annotation is an id-encoded PNG (id = R + 256 G + 256^2 B, see
``rgb2id``/``id2rgb``) with per-segment category ids, and a categories
table telling things from stuff (``isthing``). ``sample=True`` gives the
JAX package's 8 synthetic frames, made from the same numpy seeds: two stuff
half-planes (sky, road) and 1-2 thing rectangles, each a segment with its
box. On disk: ``annotations/panoptic_{train,val}2017.json`` and the PNGs
of ``annotations/panoptic_{train,val}2017/``, decoded by the native loader,
one item per annotated image; a segment absent from its PNG is dropped.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels, Mask
from .base_dataset import BaseDataset, Split
from .mixins import SplitMixin


def rgb2id(png: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> (H, W) uint32 segment ids, id = R + 256 G + 256^2 B."""
    png = png.astype(np.uint32)
    return png[..., 0] + 256 * png[..., 1] + 256 * 256 * png[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Inverse of ``rgb2id``: segment ids -> (H, W, 3) uint8 RGB."""
    ids = ids.astype(np.uint32)
    return np.stack([ids % 256, (ids // 256) % 256, ids // (256 * 256)],
                    axis=-1).astype(np.uint8)


class CocoPanopticDataset(SplitMixin, BaseDataset):
    """getitem -> Frame (CHW float32, normalization "255") with a
    ``segmentation`` (N, H, W) ``Mask`` of its segments and their boxes2d
    (relative xcyc), both with ``Labels`` carrying ``labels_names``.
    ``isthing`` maps each category id to True (thing) or False (stuff)."""

    SPLIT_FOLDERS = {Split.TRAIN: "train2017", Split.VAL: "val2017"}
    SAMPLE_CLASSES = ("person", "car", "sky", "road")
    SAMPLE_ISTHING = (True, True, False, False)

    def __init__(self, split: Split = Split.TRAIN, sample: bool = False,
                 img_folder: Optional[str] = None,
                 ann_folder: Optional[str] = None,
                 ann_file: Optional[str] = None, **kwargs):
        self.split = split
        super().__init__(name="coco_panoptic", sample=sample, **kwargs)
        if sample:
            self.items = list(range(8))
            self.labels_names = list(self.SAMPLE_CLASSES)
            self.isthing = dict(enumerate(self.SAMPLE_ISTHING))
            return
        img_folder = img_folder or self.get_split_folder()
        tag = "train" if split == Split.TRAIN else "val"
        ann_file = ann_file or f"annotations/panoptic_{tag}2017.json"
        ann_folder = ann_folder or f"annotations/panoptic_{tag}2017"
        self.img_folder = os.path.join(self.dataset_dir, img_folder)
        self.ann_folder = os.path.join(self.dataset_dir, ann_folder)
        with open(os.path.join(self.dataset_dir, ann_file)) as f:
            coco = json.load(f)
        cats = {c["id"]: c for c in coco["categories"]}
        self.labels_names = ["N/A"] * (max(cats) + 1)
        self.isthing = {}
        for cid, c in cats.items():
            self.labels_names[cid] = c["name"]
            self.isthing[cid] = bool(c.get("isthing", 1))
        self.imgs = {i["id"]: i for i in coco["images"]}
        self.anns = coco["annotations"]
        self.items = list(range(len(self.anns)))

    def _getitem_sample(self, idx: int) -> Frame:
        """Deterministic synthetic frame ``idx``."""
        rng = np.random.RandomState(1100 + idx)
        H, W = 96, 128
        img = rng.uniform(0, 120, (3, H, W)).astype(np.float32)
        masks, labels, boxes = [], [], []
        sky = np.zeros((H, W), np.float32)
        sky[:H // 3] = 1
        road = np.zeros((H, W), np.float32)
        road[2 * H // 3:] = 1
        for m, c in ((sky, 2), (road, 3)):
            masks.append(m)
            labels.append(c)
            ys, xs = np.nonzero(m)
            boxes.append([(xs.min() + xs.max()) / 2 / W,
                          (ys.min() + ys.max()) / 2 / H,
                          (xs.max() - xs.min() + 1) / W,
                          (ys.max() - ys.min() + 1) / H])
        for _ in range(rng.randint(1, 3)):
            w, h = rng.uniform(0.1, 0.3), rng.uniform(0.1, 0.3)
            xc = rng.uniform(w / 2, 1 - w / 2)
            yc = rng.uniform(h / 2, 1 - h / 2)
            x0, x1 = int((xc - w / 2) * W), int((xc + w / 2) * W)
            y0, y1 = int((yc - h / 2) * H), int((yc + h / 2) * H)
            m = np.zeros((H, W), np.float32)
            m[y0:y1, x0:x1] = 1
            img[:, y0:y1, x0:x1] = rng.uniform(130, 255, (3, 1, 1))
            masks.append(m)
            labels.append(rng.randint(0, 2))
            boxes.append([xc, yc, w, h])
        frame = Frame(torch.from_numpy(img))
        lab = Labels(torch.tensor(labels, dtype=torch.float32),
                     labels_names=self.labels_names)
        frame.append_segmentation(Mask(torch.from_numpy(np.stack(masks)),
                                       labels=lab))
        frame.append_boxes2d(BoundingBoxes2D(
            torch.tensor(np.asarray(boxes, np.float32)), boxes_format="xcyc",
            absolute=False, labels=lab.clone()))
        return frame

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        from ..runtime import decode
        ann = self.anns[idx]
        info = self.imgs[ann["image_id"]]
        frame = Frame(os.path.join(self.img_folder, info["file_name"]))
        H, W = frame.HW
        ids = rgb2id(decode(os.path.join(self.ann_folder, ann["file_name"]),
                            "color").numpy())
        masks, labels, boxes = [], [], []
        for seg in ann["segments_info"]:
            m = (ids == seg["id"]).astype(np.float32)
            if m.sum() == 0:
                continue
            masks.append(m)
            labels.append(seg["category_id"])
            x, y, w, h = seg["bbox"]
            boxes.append([(x + w / 2) / W, (y + h / 2) / H, w / W, h / H])
        lab = Labels(torch.tensor(np.asarray(labels, np.float32)),
                     labels_names=self.labels_names)
        frame.append_segmentation(Mask(torch.from_numpy(
            np.stack(masks) if masks else np.zeros((0, H, W), np.float32)),
            labels=lab))
        frame.append_boxes2d(BoundingBoxes2D(
            torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 4)),
            boxes_format="xcyc", absolute=False, labels=lab.clone()))
        return frame
