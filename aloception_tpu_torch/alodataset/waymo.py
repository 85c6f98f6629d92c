"""Waymo Open Dataset (counterpart of ``aloception_tpu/alodataset/waymo.py``).

``WaymoDataset.prepare`` converts the segments' TFRecords once
(``prepare/waymo_converter.py``) into the layout the dataset reads:

    <dataset_dir>/<split>/<segment>/<camera>/{%06d.jpg, %06d.json}

where the JSON carries the absolute xcyc 2-D boxes, the 3-D boxes in the
vehicle frame ([cx, cy, cz, length, width, height, heading], Waymo axes),
their class ids, the camera's 3x4 intrinsic and its camera -> vehicle
extrinsic. getitem gives {camera: Frame (T, C, H, W)} over ``sequence_size``
frames ``sequence_skip + 1`` apart, each frame with the boxes ``labels``
names ("gt_boxes_2d", "gt_boxes_3d") and its calibration. The 3-D boxes
and the extrinsic are turned into aloception's axes (X right, Y down, Z
forward): boxes [xc, yc, zc, Dx, Dy, Dz, heading], and the vehicle ->
camera transform ``W @ inv(E) @ inv(W)`` computed in float64 and cast to
float32, as the JAX package does.

``sample=True`` gives the JAX package's 4 deterministic items, from the same
numpy seeds.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..aloscene import (BoundingBoxes2D, BoundingBoxes3D, CameraExtrinsic,
                        CameraIntrinsic, Frame, Labels)
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split
from .mixins import SequenceMixin, SplitMixin

CAMERAS = ("front", "front_left", "front_right", "side_left", "side_right")
CLASSES = ("vehicle", "pedestrian", "sign", "cyclist")

# Waymo axes (X forward, Y left, Z up) -> aloception axes (X right, Y down,
# Z forward)
_WAYMO2ALO = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                       [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def _waymo_to_alo_boxes3d(b: np.ndarray) -> np.ndarray:
    """[cx, cy, cz, length, width, height, heading] in Waymo's vehicle axes
    -> [xc, yc, zc, Dx, Dy, Dz, heading] in aloception's, in ``b``'s
    dtype."""
    center = b[:, :3] @ _WAYMO2ALO[:3, :3].T.astype(b.dtype)
    dims = b[:, [4, 5, 3]]
    heading = -b[:, 6:7]
    return np.concatenate([center, dims, heading], -1)


def _labels(ids) -> Labels:
    return Labels(torch.from_numpy(np.asarray(ids, np.float32)),
                  labels_names=CLASSES)


class WaymoDataset(SequenceMixin, SplitMixin, BaseDataset):
    """getitem -> {camera: Frame (T, C, H, W)}, float32, normalization
    "255"."""

    SPLIT_FOLDERS = {Split.TRAIN: "train", Split.VAL: "validation",
                     Split.TEST: "testing"}

    def __init__(self, split: Split = Split.TRAIN,
                 cameras: List[str] = ("front",), sequence_size: int = 2,
                 labels: List[str] = ("gt_boxes_2d",), sample: bool = False,
                 **kwargs):
        self.split = split
        self.cameras = list(cameras)
        self.labels = list(labels)
        super().__init__(name="waymo", sample=sample,
                         sequence_size=sequence_size, **kwargs)
        if sample:
            self.items = list(range(4))
            return
        self.base = os.path.join(self.dataset_dir, self.get_split_folder())
        self.items = []
        for segment in sorted(os.listdir(self.base)):
            cam0_dir = os.path.join(self.base, segment, self.cameras[0])
            if not os.path.isdir(cam0_dir):
                continue
            ids = [int(os.path.splitext(os.path.basename(p))[0]) for p in
                   sorted(glob.glob(os.path.join(cam0_dir, "*.jpg")))]
            step = self.sequence_skip + 1
            span = (self.sequence_size - 1) * step
            for i in range(0, len(ids) - span):
                self.items.append(
                    (segment, [ids[i + k * step]
                               for k in range(self.sequence_size)]))

    def _frame(self, segment: str, camera: str, fid: int) -> Frame:
        folder = os.path.join(self.base, segment, camera)
        frame = Frame(os.path.join(folder, f"{fid:06d}.jpg"))
        meta_path = os.path.join(folder, f"{fid:06d}.json")
        if not os.path.exists(meta_path):
            return frame
        with open(meta_path) as f:
            meta = json.load(f)
        H, W = frame.HW
        if "gt_boxes_2d" in self.labels and "boxes2d" in meta:
            b = np.asarray(meta["boxes2d"], np.float32).reshape(-1, 4)
            frame.append_boxes2d(BoundingBoxes2D(
                torch.from_numpy(b), "xcyc", True, frame_size=(H, W),
                labels=_labels(meta.get("classes2d", [0] * len(b)))))
        if "gt_boxes_3d" in self.labels and "boxes3d" in meta:
            b3 = _waymo_to_alo_boxes3d(
                np.asarray(meta["boxes3d"], np.float32).reshape(-1, 7))
            frame.append_boxes3d(BoundingBoxes3D(
                torch.from_numpy(b3),
                labels=_labels(meta.get("classes3d", [0] * len(b3)))))
        if "intrinsic" in meta:
            frame.append_cam_intrinsic(CameraIntrinsic(torch.from_numpy(
                np.asarray(meta["intrinsic"], np.float32).reshape(3, 4))))
        if "extrinsic" in meta:
            E = np.asarray(meta["extrinsic"], np.float64).reshape(4, 4)
            ext = _WAYMO2ALO @ np.linalg.inv(E) @ np.linalg.inv(_WAYMO2ALO)
            frame.append_cam_extrinsic(CameraExtrinsic(
                torch.from_numpy(ext.astype(np.float32))))
        return frame

    def _getitem_sample(self, idx: int) -> Dict[str, Frame]:
        rng = np.random.RandomState(1200 + idx)
        out = {}
        for cam in self.cameras:
            frames = []
            for t in range(self.sequence_size):
                f = Frame(torch.from_numpy(
                    rng.uniform(0, 255, (3, 96, 128)).astype(np.float32)))
                f.append_boxes2d(BoundingBoxes2D(
                    torch.tensor([[0.5, 0.6, 0.2, 0.2]]), "xcyc", False,
                    labels=Labels(torch.tensor([0.0]), labels_names=CLASSES)))
                frames.append(f.temporal())
            out[cam] = _cat_batched(frames, axis_name="T")
        return out

    def getitem(self, idx: int) -> Dict[str, Frame]:
        if self.sample:
            return self._getitem_sample(idx)
        segment, fids = self.items[idx]
        return {cam: _cat_batched(
            [self._frame(segment, cam, fid).temporal() for fid in fids],
            axis_name="T") for cam in self.cameras}

    @staticmethod
    def prepare(tfrecord_dir: str, out_dir: str) -> List[str]:
        """Every ``*.tfrecord`` of ``tfrecord_dir`` -> the layout above under
        ``out_dir`` (a split folder); returns the segment directories."""
        from .prepare.waymo_converter import prepare as _prepare
        return _prepare(tfrecord_dir, out_dir)
