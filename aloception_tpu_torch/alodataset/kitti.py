"""The KITTI datasets (counterpart of ``aloception_tpu/alodataset/kitti.py``):
stereo, flow and scene flow 2015 (and the 2012 benchmark through the same
folder names), depth, 3-D objects, tracking, odometry, road and semantic
segmentation, and the depth train/val split with its validity mask.

Split folders are ``training/`` (TRAIN, VAL) and ``testing/`` (TEST); frame
ids are zero-padded. The 16-bit PNG encodings are read at their stored
depth by ``runtime.decode``, which gives the channels in RGB order:

- flow: (u, v) = (R - 2^15) / 64, (G - 2^15) / 64, valid where B > 0; the
  occlusion ``Mask`` is 1 where not valid;
- disparity and depth: the grey value / 256.

Calibration comes from ``calib_cam_to_cam/<id>.txt`` (``P_rect_0X``) or,
for the object benchmark, ``calib/<id>.txt`` (``PX``), as 3x4 intrinsics.

Behaviour kept from the JAX package (ROADMAP §C): ``KittiStereoFlow2012``
reads the 2015 folder names; ``KittiRoad``'s road mask is the red channel
of the ground-truth PNG; ``KittiDepth`` takes a sample frame where the RGB
file is missing.

``sample=True`` gives the JAX package's deterministic items, from the same
numpy seeds.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..aloscene import (BoundingBoxes2D, BoundingBoxes3D, CameraIntrinsic,
                        Depth, Disparity, Flow, Frame, Labels, Mask, Pose)
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split
from .mixins import SequenceMixin, SplitMixin
from .utils.kitti import (baseline_from_calib, intrinsic_from_calib,
                          load_calib_cam_to_cam)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _temporal(frames: List[Frame]) -> Frame:
    return _cat_batched([f.temporal() for f in frames], axis_name="T")


def load_kitti_flow_png(path: str):
    """KITTI's 16-bit flow PNG -> ((2, H, W) float32 flow, (H, W) bool
    valid)."""
    from ..runtime import decode
    img = decode(path, "unchanged").float()
    flow = (img[..., :2] - 2 ** 15) / 64.0
    return flow.permute(2, 0, 1).contiguous(), img[..., 2] > 0


def load_kitti_16bit_png(path: str) -> torch.Tensor:
    """A 16-bit grey PNG (disparity or depth) -> (1, H, W) float32 value /
    256."""
    from ..runtime import decode
    return (decode(path, "unchanged").float() / 256.0).permute(2, 0, 1)


class KittiBase(SplitMixin, BaseDataset):
    SPLIT_FOLDERS = {Split.TRAIN: "training", Split.VAL: "training",
                     Split.TEST: "testing"}

    def __init__(self, name: str, split: Split = Split.TRAIN,
                 sample: bool = False, **kwargs):
        self.split = split
        super().__init__(name=name, sample=sample, **kwargs)
        if sample:
            self.items = list(range(4))
            return
        self.split_folder = os.path.join(self.dataset_dir,
                                         self.get_split_folder())

    def _sample_frame(self, idx: int, size=(96, 128)) -> Frame:
        rng = np.random.RandomState(4000 + idx)
        return Frame(_t(rng.uniform(0, 255, (3,) + size).astype(np.float32)))


class KittiStereoFlowSFlow2015(KittiBase):
    """Scene flow 2015: stereo pairs at t and t+1 -> {"left": Frame (T=2),
    "right": Frame (T=2)}. The left frames carry the disparities that
    ``load`` names ("disp_noc", "disp_occ", with the stereo baseline): the
    one at t ``disp_*_0``, the one at t+1 ``disp_*_1`` (the benchmark's
    disparity of the second pair, on the first frame's pixels); the left
    frame at t carries the flows ("flow_occ", "flow_noc"). Every frame
    carries its camera's intrinsic when the calibration file exists. (The
    JAX package attaches the disparity at t only, and its sequence then
    fails to concatenate: ROADMAP §C.)"""

    def __init__(self, name: str = "kitti_sflow2015", grayscale: bool = False,
                 load: Optional[List[str]] = None, **kwargs):
        self.load = load or ["right", "disp_noc", "disp_occ", "flow_occ",
                             "flow_noc"]
        super().__init__(name=name, **kwargs)
        if self.sample:
            return
        imgs = glob.glob(os.path.join(self.split_folder, "image_2",
                                      "*_10.png"))
        self.items = sorted(int(os.path.basename(p).split("_")[0])
                            for p in imgs)

    def getitem(self, idx: int) -> Dict[str, Frame]:
        if self.sample:
            out = {"left": _temporal([self._sample_frame(idx),
                                      self._sample_frame(idx + 1)])}
            if "right" in self.load:
                out["right"] = _temporal([self._sample_frame(idx + 2),
                                          self._sample_frame(idx + 3)])
            return out
        fid = self.items[idx]
        calib_path = os.path.join(self.split_folder, "calib_cam_to_cam",
                                  f"{fid:06d}.txt")
        calib = load_calib_cam_to_cam(calib_path) \
            if os.path.exists(calib_path) else {}

        def frame_at(cam_folder: str, t: int, cam: int) -> Frame:
            f = Frame(os.path.join(self.split_folder, cam_folder,
                                   f"{fid:06d}_{10 + t:02d}.png"))
            if calib:
                f.append_cam_intrinsic(
                    CameraIntrinsic(_t(intrinsic_from_calib(calib, cam))))
            return f

        left0, left1 = frame_at("image_2", 0, 2), frame_at("image_2", 1, 2)
        for t, frame in enumerate((left0, left1)):
            for key in ("disp_noc", "disp_occ"):
                path = os.path.join(self.split_folder, f"{key}_{t}",
                                    f"{fid:06d}_10.png")
                if key in self.load and os.path.exists(path):
                    frame.append_disparity(
                        Disparity(load_kitti_16bit_png(path),
                                  disp_format="unsigned",
                                  baseline=baseline_from_calib(calib)), key)
        for key in ("flow_occ", "flow_noc"):
            path = os.path.join(self.split_folder, key, f"{fid:06d}_10.png")
            if key in self.load and os.path.exists(path):
                flow, valid = load_kitti_flow_png(path)
                left0.append_flow(Flow(
                    flow, occlusion=Mask((~valid[None]).float())), key)
        out = {"left": _temporal([left0, left1])}
        if "right" in self.load and os.path.exists(
                os.path.join(self.split_folder, "image_3",
                             f"{fid:06d}_10.png")):
            out["right"] = _temporal([frame_at("image_3", 0, 3),
                                      frame_at("image_3", 1, 3)])
        return out


class KittiStereoFlow2012(KittiStereoFlowSFlow2015):
    """The 2012 benchmark, read through the 2015 folder names (kept from the
    JAX package, ROADMAP §C)."""

    def __init__(self, name: str = "kitti_stereo2012", **kwargs):
        super().__init__(name=name, **kwargs)


class KittiDepth(KittiBase):
    """Depth: ``<subset>/**/proj_depth/groundtruth/image_02/*.png`` maps
    (16-bit / 256) on the frames of ``<drive>/image_02/data/``, a sample
    frame where that file is missing."""

    def __init__(self, name: str = "kitti_depth", subset: str = "val",
                 **kwargs):
        self.subset = subset
        super().__init__(name=name, **kwargs)
        if self.sample:
            return
        pattern = os.path.join(self.dataset_dir, subset, "**", "proj_depth",
                               "groundtruth", "image_02", "*.png")
        self.depth_paths = sorted(glob.glob(pattern, recursive=True))
        self.items = list(range(len(self.depth_paths)))

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            frame = self._sample_frame(idx)
            frame.append_depth(Depth(_t(np.random.RandomState(idx).uniform(
                1, 80, (1,) + frame.HW).astype(np.float32))))
            return frame
        depth_path = self.depth_paths[idx]
        img_path = depth_path.replace(
            os.sep + "proj_depth" + os.sep + "groundtruth", "").replace(
            "image_02", os.path.join("image_02", "data"))
        frame = Frame(img_path) if os.path.exists(img_path) \
            else self._sample_frame(idx)
        frame.append_depth(Depth(load_kitti_16bit_png(depth_path)))
        return frame


class KittiObject(KittiBase):
    """3-D objects: ``label_2`` lines of the 8 classes -> relative xcyc
    ``BoundingBoxes2D`` and ``BoundingBoxes3D`` [x, y - h / 2, z, w, h, l,
    ry] (the box's centre), with their ``Labels``; the intrinsic of
    ``calib``'s P2."""

    CLASSES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting",
               "Cyclist", "Tram", "Misc")

    def __init__(self, name: str = "kitti_object", **kwargs):
        super().__init__(name=name, **kwargs)
        if self.sample:
            return
        imgs = glob.glob(os.path.join(self.split_folder, "image_2", "*.png"))
        self.items = sorted(int(os.path.splitext(os.path.basename(p))[0])
                            for p in imgs)

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            frame = self._sample_frame(idx)
            frame.append_boxes2d(BoundingBoxes2D(
                torch.tensor([[0.5, 0.5, 0.2, 0.3]]), "xcyc", False,
                labels=Labels(torch.tensor([0.0]),
                              labels_names=self.CLASSES)))
            frame.append_boxes3d(BoundingBoxes3D(
                torch.tensor([[0.0, 1.0, 15.0, 1.6, 1.5, 4.0, 0.2]])))
            return frame
        fid = self.items[idx]
        frame = Frame(os.path.join(self.split_folder, "image_2",
                                   f"{fid:06d}.png"))
        H, W = frame.HW
        label_path = os.path.join(self.split_folder, "label_2",
                                  f"{fid:06d}.txt")
        boxes2d, boxes3d, labels = [], [], []
        if os.path.exists(label_path):
            with open(label_path) as f:
                for line in f:
                    p = line.split()
                    if p[0] not in self.CLASSES:
                        continue
                    x1, y1, x2, y2 = map(float, p[4:8])
                    h, w, l = map(float, p[8:11])
                    x, y, z = map(float, p[11:14])
                    boxes2d.append([(x1 + x2) / 2 / W, (y1 + y2) / 2 / H,
                                    (x2 - x1) / W, (y2 - y1) / H])
                    boxes3d.append([x, y - h / 2, z, w, h, l, float(p[14])])
                    labels.append(self.CLASSES.index(p[0]))
        lab = Labels(_t(np.asarray(labels, np.float32)),
                     labels_names=self.CLASSES)
        frame.append_boxes2d(BoundingBoxes2D(
            _t(np.asarray(boxes2d, np.float32).reshape(-1, 4)), "xcyc",
            False, labels=lab))
        frame.append_boxes3d(BoundingBoxes3D(
            _t(np.asarray(boxes3d, np.float32).reshape(-1, 7)),
            labels=lab.clone()))
        calib_path = os.path.join(self.split_folder, "calib", f"{fid:06d}.txt")
        if os.path.exists(calib_path):
            calib = load_calib_cam_to_cam(calib_path)
            try:
                frame.append_cam_intrinsic(
                    CameraIntrinsic(_t(intrinsic_from_calib(calib, 2))))
            except KeyError:
                pass
        return frame


class KittiTracking(SequenceMixin, KittiBase):
    """Tracking: ``sequence_size`` consecutive frames of each sequence of
    ``image_02/``, as a Frame (T, C, H, W)."""

    def __init__(self, name: str = "kitti_tracking", sequence_size: int = 2,
                 **kwargs):
        super().__init__(name=name, sequence_size=sequence_size, **kwargs)
        if self.sample:
            return
        self.items = []
        for sd in sorted(glob.glob(os.path.join(self.split_folder, "image_02",
                                                "*"))):
            frames = sorted(glob.glob(os.path.join(sd, "*.png")))
            for i in range(len(frames) - self.sequence_size + 1):
                self.items.append(frames[i:i + self.sequence_size])

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return _temporal([self._sample_frame(idx + t)
                              for t in range(self.sequence_size)])
        return _temporal([Frame(p) for p in self.items[idx]])


class KittiOdometry(SequenceMixin, KittiBase):
    """Odometry: ``sequence_size`` consecutive frames of
    ``sequences/<seq>/image_2/``, each with its ground-truth ``Pose`` from
    ``poses/<seq>.txt`` (3x4 rows) when that file exists."""

    def __init__(self, name: str = "kitti_odometry", sequence_size: int = 2,
                 **kwargs):
        super().__init__(name=name, sequence_size=sequence_size, **kwargs)
        if self.sample:
            return
        self.items = []
        self.poses = {}
        for sd in sorted(glob.glob(os.path.join(self.dataset_dir, "sequences",
                                                "*"))):
            seq = os.path.basename(sd)
            frames = sorted(glob.glob(os.path.join(sd, "image_2", "*.png")))
            pose_path = os.path.join(self.dataset_dir, "poses", seq + ".txt")
            if os.path.exists(pose_path):
                self.poses[seq] = np.loadtxt(pose_path).reshape(-1, 3, 4)
            for i in range(len(frames) - self.sequence_size + 1):
                self.items.append((seq, i, frames[i:i + self.sequence_size]))

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            frames = []
            for t in range(self.sequence_size):
                f = self._sample_frame(idx + t)
                f.append_pose(Pose(torch.eye(4)))
                frames.append(f)
            return _temporal(frames)
        seq, start, paths = self.items[idx]
        frames = []
        for t, p in enumerate(paths):
            f = Frame(p)
            if seq in self.poses:
                T = np.eye(4, dtype=np.float32)
                T[:3] = self.poses[seq][start + t]
                f.append_pose(Pose(_t(T)))
            frames.append(f)
        return _temporal(frames)


class KittiRoad(KittiBase):
    """Road segmentation: each ``image_2/<cat>_<rest>`` frame with the
    road ``Mask`` of ``gt_image_2/<cat>_road_<rest>``: its red channel > 0
    (kept from the JAX package, ROADMAP §C)."""

    def __init__(self, name: str = "kitti_road", **kwargs):
        super().__init__(name=name, **kwargs)
        if self.sample:
            return
        self.items = sorted(glob.glob(os.path.join(self.split_folder,
                                                   "image_2", "*.png")))

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            frame = self._sample_frame(idx)
            m = torch.zeros((1,) + frame.HW)
            m[0, frame.H // 2:] = 1
            frame.append_segmentation(Mask(m))
            return frame
        from ..runtime import decode
        path = self.items[idx]
        frame = Frame(path)
        cat, rest = os.path.basename(path).split("_", 1)
        gt = os.path.join(self.split_folder, "gt_image_2",
                          f"{cat}_road_{rest}")
        if os.path.exists(gt):
            road = (decode(gt, "color")[..., 0] > 0).float()[None]
            frame.append_segmentation(Mask(road))
        return frame


class KittiSemantic(KittiBase):
    """Semantic segmentation: each ``image_2`` frame with one ``Mask`` per
    id of its ``semantic`` PNG read as grey, in ascending id order, labelled
    by the ids."""

    def __init__(self, name: str = "kitti_semantic", **kwargs):
        super().__init__(name=name, **kwargs)
        if self.sample:
            return
        self.items = sorted(glob.glob(os.path.join(self.split_folder,
                                                   "image_2", "*.png")))

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            frame = self._sample_frame(idx)
            classes = np.random.RandomState(idx).randint(0, 3, frame.HW)
            masks = np.stack([(classes == c).astype(np.float32)
                              for c in range(3)])
            frame.append_segmentation(Mask(_t(masks), labels=Labels(
                torch.arange(3, dtype=torch.float32))))
            return frame
        from ..runtime import decode
        path = self.items[idx]
        frame = Frame(path)
        gt = path.replace("image_2", "semantic")
        if os.path.exists(gt):
            sem = decode(gt, "gray")[..., 0].numpy()
            ids = np.unique(sem)
            masks = np.stack([(sem == i).astype(np.float32) for i in ids])
            frame.append_segmentation(Mask(_t(masks), labels=Labels(
                _t(ids.astype(np.float32)))))
        return frame


# the reference's names
KittiStereoFlowSFlow2015Dataset = KittiStereoFlowSFlow2015
KittiStereoFlow2012Dataset = KittiStereoFlow2012
KittiDepthDataset = KittiDepth
KittiObjectDataset = KittiObject
KittiTrackingDataset = KittiTracking
KittiOdometryDataset = KittiOdometry


class KittiSplit(KittiDepth):
    """Train/val split over the prepared KITTI depth drives (``train/``,
    ``val/``); the depth carries a ``valid_mask`` child, 1 where the depth
    is not 0 (a lidar return), mergeable along B and T."""

    SPLIT_FOLDERS = {Split.VAL: "val", Split.TRAIN: "train"}

    def __init__(self, split: Split = Split.TRAIN, add_depth_mask: bool = True,
                 name: str = "kitti", **kwargs):
        self.add_depth_mask = add_depth_mask
        super().__init__(name=name, split=split,
                         subset=self.SPLIT_FOLDERS[split], **kwargs)

    def getitem(self, idx: int) -> Frame:
        frame = super().getitem(idx)
        depth = frame.get_child("depth")
        if self.add_depth_mask and depth is not None \
                and not isinstance(depth, dict):
            valid = (depth.array != 0).float()
            depth.add_child("valid_mask", Mask(valid, names=depth.names),
                            align_dim=["B", "T"], mergeable=True)
        return frame


KittiSplitDataset = KittiSplit
