"""COCO detection datasets (counterpart of
``aloception_tpu/alodataset/coco_detection.py``).

On disk: the annotation JSON is indexed directly (images, each image's
annotations, categories), the images are decoded by ``runtime.decode``, and
segmentations (polygons, uncompressed RLE) are rasterized by the loader's
``fill_poly``, which reproduces ``cv2.fillPoly``. As in the JAX package,
crowd annotations (``iscrowd``) are dropped when the file is parsed, labels
are the category ids (``labels_names`` is indexed by id, "N/A" between), and
``classes=`` keeps those classes only, relabelled 0..len(classes)-1, and the
images that hold one.

``sample=True`` gives the JAX package's 12 deterministic synthetic frames,
made from the same numpy seeds, so both packages give the same images, boxes,
labels and masks for an index.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels, Mask
from .base_dataset import BaseDataset, Split
from .mixins import SplitMixin


def poly_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO polygon(s) or uncompressed RLE -> a float32 (h, w) mask (an RLE
    takes its own ``size``)."""
    if isinstance(segmentation, dict):  # uncompressed RLE, column-major
        counts, size = segmentation["counts"], segmentation["size"]
        flat = np.zeros(size[0] * size[1], np.uint8)
        pos, val = 0, 0
        for c in counts:
            flat[pos:pos + c] = val
            pos += c
            val = 1 - val
        return flat.reshape(size[1], size[0]).T.astype(np.float32)
    from ..runtime import fill_poly
    mask = np.zeros((h, w), np.uint8)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(mask, np.round(pts).astype(np.int32))
    return mask.astype(np.float32)


def _targets(frame: Frame, boxes: List, labels: List, masks: Optional[List],
             labels_names) -> Frame:
    """Attach boxes2d (relative xcyc) with Labels and, if ``masks`` is a
    list, a segmentation Mask with a copy of the Labels."""
    H, W = frame.HW
    lab = Labels(torch.tensor(np.asarray(labels, np.float32)),
                 labels_names=labels_names)
    frame.append_boxes2d(BoundingBoxes2D(
        torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 4)),
        boxes_format="xcyc", absolute=False, labels=lab))
    if masks is not None:
        seg = np.stack(masks) if masks else np.zeros((0, H, W), np.float32)
        frame.append_segmentation(Mask(torch.from_numpy(seg),
                                       labels=lab.clone()))
    return frame


class CocoBaseDataset(BaseDataset):
    """getitem -> Frame (CHW float32, normalization "255") with boxes2d
    (relative xcyc) carrying ``Labels`` with ``labels_names`` and, with
    ``return_masks``, a ``segmentation`` child: a (N, H, W) ``Mask`` of the
    objects, with the same ``Labels``. On disk, ``img_folder`` and
    ``ann_file`` are relative to the dataset directory."""

    SAMPLE_CLASSES = ("person", "car", "dog", "chair")

    def __init__(self, img_folder: Optional[str] = None,
                 ann_file: Optional[str] = None, name: str = "coco",
                 return_masks: bool = False,
                 classes: Optional[List[str]] = None, sample: bool = False,
                 **kwargs):
        super().__init__(name=name, sample=sample, **kwargs)
        self.return_masks = return_masks
        self.classes = classes
        if sample:
            self.items = list(range(12))
            self.labels_names = list(self.SAMPLE_CLASSES)
            return
        if img_folder is None or ann_file is None:
            raise ValueError("COCO on disk needs img_folder and ann_file")
        self.img_folder = os.path.join(self.dataset_dir, img_folder)
        with open(os.path.join(self.dataset_dir, ann_file)) as f:
            coco = json.load(f)

        cats = {c["id"]: c["name"] for c in coco.get("categories", [])}
        self.labels_names = ["N/A"] * ((max(cats) if cats else 0) + 1)
        for cid, cname in cats.items():
            self.labels_names[cid] = cname
        self._cat_remap = None
        if classes is not None:
            missing = [c for c in classes if c not in cats.values()]
            if missing:
                raise ValueError(f"unknown classes: {missing}")
            self._cat_remap = {cid: classes.index(cname)
                               for cid, cname in cats.items()
                               if cname in classes}
            self.labels_names = list(classes)

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if self._cat_remap is not None \
                    and a["category_id"] not in self._cat_remap:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.imgs = {i["id"]: i for i in coco["images"]}
        img_ids = sorted(self.imgs)
        if classes is not None:
            img_ids = [i for i in img_ids if anns_by_img.get(i)]
        self.items = img_ids
        self.anns_by_img = anns_by_img

    def _getitem_sample(self, idx: int) -> Frame:
        """Deterministic synthetic frame ``idx``."""
        rng = np.random.RandomState(1000 + idx)
        H, W = rng.randint(180, 260), rng.randint(240, 340)
        img = rng.uniform(0, 80, (3, H, W)).astype(np.float32)
        n = rng.randint(1, 5)
        boxes, labels, masks = [], [], []
        for _ in range(n):
            w, h = rng.uniform(0.1, 0.4), rng.uniform(0.1, 0.4)
            xc = rng.uniform(w / 2, 1 - w / 2)
            yc = rng.uniform(h / 2, 1 - h / 2)
            cls = rng.randint(0, len(self.SAMPLE_CLASSES))
            x0, x1 = int((xc - w / 2) * W), int((xc + w / 2) * W)
            y0, y1 = int((yc - h / 2) * H), int((yc + h / 2) * H)
            img[:, y0:y1, x0:x1] = rng.uniform(100, 255, (3, 1, 1))
            boxes.append([xc, yc, w, h])
            labels.append(cls)
            m = np.zeros((H, W), np.float32)
            m[y0:y1, x0:x1] = 1.0
            masks.append(m)
        frame = Frame(torch.from_numpy(img), normalization="255")
        return _targets(frame, boxes, labels,
                        masks if self.return_masks else None,
                        self.labels_names)

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        img_id = self.items[idx]
        info = self.imgs[img_id]
        frame = Frame(os.path.join(self.img_folder, info["file_name"]))
        H, W = frame.HW
        boxes, labels, masks = [], [], []
        for a in self.anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]  # absolute xywh
            if w <= 0 or h <= 0:
                continue
            boxes.append([(x + w / 2) / W, (y + h / 2) / H, w / W, h / H])
            cid = a["category_id"]
            labels.append(self._cat_remap[cid] if self._cat_remap else cid)
            if self.return_masks and "segmentation" in a:
                masks.append(poly_to_mask(a["segmentation"], H, W))
        return _targets(frame, boxes, labels,
                        masks if self.return_masks else None,
                        self.labels_names)


class CocoDetectionDataset(SplitMixin, CocoBaseDataset):
    """COCO detection by split: ``train2017``/``val2017``/``test2017``
    folders and ``annotations/instances_{train,val}2017.json``."""

    SPLIT_FOLDERS = {Split.TRAIN: "train2017", Split.VAL: "val2017",
                     Split.TEST: "test2017"}
    SPLIT_ANN_FILES = {
        Split.TRAIN: "annotations/instances_train2017.json",
        Split.VAL: "annotations/instances_val2017.json",
        Split.TEST: None,
    }

    def __init__(self, split: Split = Split.TRAIN, name: str = "coco",
                 **kwargs):
        self.split = split
        kwargs.setdefault("img_folder", self.SPLIT_FOLDERS[split])
        kwargs.setdefault("ann_file", self.SPLIT_ANN_FILES[split])
        super().__init__(name=name, **kwargs)
