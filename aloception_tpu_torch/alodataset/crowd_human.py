"""CrowdHuman person detection (counterpart of
``aloception_tpu/alodataset/crowd_human.py``; reference:
alodataset/crowd_human_dataset.py:19).

On disk: ``<dir>/CrowdHuman_{train,val}/Images/*.jpg`` and
``annotation_{train,val}.odgt`` (a JSON record a line: {"ID", "gtboxes":
[{"tag", "fbox"/"vbox"/"hbox": [x, y, w, h], "extra": {"ignore": 0|1}}]}).
Records with 2..50 raw boxes are kept; boxes tagged "mask", ignored, missing
a requested type or with a degenerate primary box are dropped. Every
requested box type is attached, under its name when there are several;
``boxes_limit`` keeps the N widest; the test split lists images only
(``CrowdHuman_test/images_test`` where it exists). A ``*_prepared``
directory holds relative boxes.

``prepare()`` writes that directory as the JAX package does: images whose
long side exceeds ``max_size`` resized by the 800/1333 rule with cv2's
uint8 bilinear (``runtime.resize_linear_u8``, bit for bit) and written as
cv2.imwrite writes a JPEG (quality 95, 4:2:0, no Huffman optimisation: the
same bytes through Pillow's libjpeg), the others copied; the annotations
divided by each image's original size; a work directory merged into the
prepared one; the dataset config repointed there.

``sample=True`` gives the JAX package's 6 deterministic items, from the same
numpy seeds.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..aloscene import BoundingBoxes2D, Frame, Labels
from ..aloscene.io.errors import InvalidSampleError
from ..runtime import decode, resize_linear_u8
from . import base_dataset
from .base_dataset import BaseDataset, Split
from .mixins import SplitMixin


def write_jpeg(path: str, rgb: np.ndarray):
    """What ``cv2.imwrite(path, bgr)`` writes for a JPEG: quality 95,
    4:2:0 chroma subsampling, standard Huffman tables."""
    Image.fromarray(rgb).save(path, "JPEG", quality=95, subsampling=2,
                              optimize=False)


class CrowdHumanDataset(SplitMixin, BaseDataset):

    SPLIT_FOLDERS = {Split.TRAIN: "CrowdHuman_train",
                     Split.VAL: "CrowdHuman_val",
                     Split.TEST: "CrowdHuman_test"}
    CLASSES = ("person",)

    def __init__(self, split: Split = Split.TRAIN, box_key: str = "fbox",
                 bbox_types: Optional[Sequence[str]] = None,
                 boxes_limit: Optional[int] = None,
                 sample: bool = False, **kwargs):
        """``box_key`` names the primary box type (``boxes2d``);
        ``bbox_types`` attaches more types under their own names;
        ``boxes_limit`` keeps the N widest boxes of an image."""
        self.split = split
        self.box_key = box_key
        self.bbox_types = tuple(bbox_types or (box_key,))
        if box_key not in self.bbox_types:
            self.bbox_types = (box_key,) + tuple(self.bbox_types)
        self.boxes_limit = boxes_limit
        super().__init__(name="CrowdHuman", sample=sample, **kwargs)
        if sample:
            self.items = list(range(6))
            return
        folder = os.path.join(self.dataset_dir, self.get_split_folder())
        self.img_folder = os.path.join(folder, "Images")
        if split == Split.TEST:
            test_dir = os.path.join(folder, "images_test")
            if os.path.isdir(test_dir):
                self.img_folder = test_dir
            self.items = [{"ID": os.path.splitext(f)[0]}
                          for f in sorted(os.listdir(self.img_folder))
                          if f.lower().endswith((".jpg", ".jpeg", ".png"))]
            return
        self.ann_file = os.path.join(self.dataset_dir, self._ann_name())
        self._rel_boxes = os.path.normpath(self.dataset_dir).endswith(
            "_prepared")
        self._load_items(self.ann_file)

    def _ann_name(self) -> str:
        return "annotation_train.odgt" if self.split == Split.TRAIN \
            else "annotation_val.odgt"

    def _load_items(self, ann_file: str):
        self.items = []
        with open(ann_file) as f:
            for line in f:
                rec = json.loads(line)
                gtboxes = rec.get("gtboxes", [])
                if not 2 <= len(gtboxes) <= 50:
                    continue
                kept = []
                for g in gtboxes:
                    if g.get("tag") != "person":
                        continue
                    if g.get("extra", {}).get("ignore", 0) != 0:
                        continue
                    if any(g.get(bt) is None for bt in self.bbox_types):
                        continue
                    pb = g[self.box_key]
                    if pb[2] <= 0 or pb[3] <= 0:
                        continue
                    kept.append({bt: g[bt] for bt in self.bbox_types})
                self.items.append({"ID": rec["ID"], "gt": kept})

    def _getitem_sample(self, idx: int) -> Frame:
        rng = np.random.RandomState(6000 + idx)
        frame = Frame(torch.from_numpy(
            rng.uniform(0, 255, (3, 120, 160)).astype(np.float32)))
        n = rng.randint(1, 6)
        boxes = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.3, 0.7, n),
                          rng.uniform(0.05, 0.15, n),
                          rng.uniform(0.2, 0.4, n)], -1).astype(np.float32)
        frame.append_boxes2d(BoundingBoxes2D(
            torch.from_numpy(boxes), "xcyc", False,
            labels=Labels(torch.zeros(n), labels_names=self.CLASSES)))
        return frame

    def _to_rel_xcyc(self, raw: List, H: int, W: int) -> np.ndarray:
        if self._rel_boxes:
            H = W = 1.0
        boxes = []
        for b in raw:
            if b is None:
                boxes.append([0.0, 0.0, 0.0, 0.0])
                continue
            x, y, w, h = b
            boxes.append([(x + w / 2) / W, (y + h / 2) / H, w / W, h / H])
        return np.asarray(boxes, np.float32).reshape(-1, 4)

    def prepare(self, short_side: int = 800, max_size: int = 1333) -> str:
        """Downscale the images once on disk and rewrite the annotations
        with relative boxes (crowd_human_dataset.py:276 prepare): an image
        whose long side exceeds ``max_size`` is resized by scale =
        min(short_side / short, max_size / long), the others are copied;
        boxes of every type are divided by the original W/H. The work
        happens in ``.wip_<name>_prepared`` beside the dataset, merged into
        ``<name>_prepared``; the config is repointed there and this
        instance reloads from it. Idempotent; returns the prepared
        directory."""
        if self.sample or self.split == Split.TEST or self._rel_boxes:
            return self.dataset_dir
        src = os.path.normpath(self.dataset_dir)
        base, name = os.path.split(src)
        wip = os.path.join(base, f".wip_{name}_prepared")
        prepared = os.path.join(base, f"{name}_prepared")
        split_folder = self.get_split_folder()
        tgt_img = os.path.join(wip, split_folder, "Images")
        fin_img = os.path.join(prepared, split_folder, "Images")
        os.makedirs(tgt_img, exist_ok=True)

        sizes = {}
        for f_name in sorted(os.listdir(self.img_folder)):
            if not f_name.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            try:
                img = decode(os.path.join(self.img_folder, f_name)).numpy()
            except InvalidSampleError:
                continue        # cv2.imread's None
            h, w = img.shape[:2]
            sizes[os.path.splitext(f_name)[0]] = (h, w)
            if os.path.exists(os.path.join(tgt_img, f_name)) \
                    or os.path.exists(os.path.join(fin_img, f_name)):
                continue
            if max(h, w) > max_size:
                scale = min(short_side / min(h, w), max_size / max(h, w))
                img = resize_linear_u8(
                    img, (int(round(h * scale)), int(round(w * scale))))
                write_jpeg(os.path.join(tgt_img, f_name), img)
            else:
                shutil.copyfile(os.path.join(self.img_folder, f_name),
                                os.path.join(tgt_img, f_name))

        tgt_ann = os.path.join(wip, self._ann_name())
        fin_ann = os.path.join(prepared, self._ann_name())
        if not os.path.exists(tgt_ann) and not os.path.exists(fin_ann):
            out_lines = []
            with open(self.ann_file) as f:
                for line in f:
                    rec = json.loads(line)
                    hw = sizes.get(rec["ID"])
                    if hw is None:
                        continue    # image missing or unreadable
                    for g in rec.get("gtboxes", []):
                        for bt in ("fbox", "vbox", "hbox"):
                            b = g.get(bt)
                            if b is None:
                                continue
                            H, W = hw
                            g[bt] = [b[0] / W, b[1] / H, b[2] / W, b[3] / H]
                    out_lines.append(json.dumps(rec))
            with open(tgt_ann, "w") as f:
                f.write("\n".join(out_lines))

        for root, _, files in os.walk(wip):
            rel = os.path.relpath(root, wip)
            dst_dir = os.path.join(prepared, rel) if rel != "." else prepared
            os.makedirs(dst_dir, exist_ok=True)
            for f_name in files:
                dst = os.path.join(dst_dir, f_name)
                if os.path.exists(dst):
                    os.remove(dst)
                shutil.move(os.path.join(root, f_name), dst)
        shutil.rmtree(wip, ignore_errors=True)

        cfg = base_dataset.load_dataset_config()
        cfg[self.name] = prepared
        base_dataset.save_dataset_config(cfg)

        self.dataset_dir = prepared
        self.img_folder = fin_img
        self.ann_file = fin_ann
        self._rel_boxes = True
        self._load_items(self.ann_file)
        return prepared

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        rec = self.items[idx]
        frame = Frame(os.path.join(self.img_folder, rec["ID"] + ".jpg"))
        if self.split == Split.TEST:
            return frame
        H, W = frame.HW
        gt = rec["gt"]
        keep = np.arange(len(gt))
        if self.boxes_limit is not None and len(gt) > self.boxes_limit:
            primary = self._to_rel_xcyc([g[self.box_key] for g in gt], H, W)
            areas = primary[:, 2] * primary[:, 3]
            keep = np.argsort(-areas)[:self.boxes_limit]
        labels = Labels(torch.zeros(len(keep)), labels_names=self.CLASSES)
        named = len(self.bbox_types) > 1
        for bt in self.bbox_types:
            arr = self._to_rel_xcyc([gt[i][bt] for i in keep], H, W)
            child = BoundingBoxes2D(torch.from_numpy(arr), "xcyc", False,
                                    labels=labels)
            frame.append_boxes2d(child, name=bt if named else None)
        return frame
