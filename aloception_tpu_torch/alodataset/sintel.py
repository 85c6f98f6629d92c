"""MPI-Sintel flow and disparity datasets (counterpart of
``aloception_tpu/alodataset/sintel.py``).

On disk (``training/`` for TRAIN and VAL, ``test/`` for TEST):
``<pass>/<scene>/frame_%04d.png`` images, ``flow/<scene>/frame_%04d.flo``
forward flow, ``occlusions/<scene>/frame_%04d.png`` occlusion masks and
``disparities/<scene>/frame_%04d.png`` disparities. Sequences are indexed
on the first pass alone: each scene's sorted frames, ``sequence_size``
frames ``sequence_skip + 1`` apart. Every frame but the last of a sequence
carries its ``flow_forward`` (when the file exists); a disparity is
``R * 4 + G / 64 + B / 16384`` of its PNG, unsigned, in pixels. An
unreadable disparity PNG is skipped, as in the JAX package.

``sample=True`` gives the JAX package's 6 deterministic sequences, made
from the same numpy seeds: 96x128 noise frames, each shifted by one pixel
from the one before, all but the last carrying a ``flow_forward`` ``Flow``
of ones and an all-zero occlusion ``Mask``.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch

from ..aloscene import Disparity, Flow, Frame, InvalidSampleError, Mask
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split
from .mixins import SequenceMixin, SplitMixin


class SintelBaseDataset(SequenceMixin, SplitMixin, BaseDataset):
    """getitem -> Frame (T, C, H, W), float32, normalization "255", with
    the labels the subclass attaches."""

    SPLIT_FOLDERS = {Split.TRAIN: "training", Split.VAL: "training",
                     Split.TEST: "test"}
    PASSES = ("clean", "final")

    def __init__(self, split: Split = Split.TRAIN,
                 cameras: List[str] = ("left",),
                 passes: List[str] = ("clean",), sample: bool = False,
                 **kwargs):
        self.split = split
        self.cameras = list(cameras)
        self.passes = list(passes)
        super().__init__(name="Sintel", sample=sample, **kwargs)
        if sample:
            self.items = list(range(6))
            return
        self.base = os.path.join(self.dataset_dir, self.get_split_folder())
        self.items = self._index_sequences()

    def _index_sequences(self):
        items = []
        render = self.passes[0]
        for scene in sorted(os.listdir(os.path.join(self.base, render))):
            frames = sorted(glob.glob(
                os.path.join(self.base, render, scene, "frame_*.png")))
            step = self.sequence_skip + 1
            span = (self.sequence_size - 1) * step
            for i in range(0, len(frames) - span):
                items.append((scene, [os.path.basename(frames[i + k * step])
                                      for k in range(self.sequence_size)]))
        return items

    def _attach_labels(self, frame: Frame, scene: str, fname: str, t: int,
                       is_last: bool):
        pass

    def _getitem_sample(self, idx: int) -> Frame:
        rng = np.random.RandomState(3000 + idx)
        H, W = 96, 128
        base = rng.uniform(0, 255, (3, H + 8, W + 8)).astype(np.float32)
        frames = []
        for t in range(self.sequence_size):
            f = Frame(torch.from_numpy(base[:, t:t + H, t:t + W].copy()),
                      normalization="255")
            if t < self.sequence_size - 1:
                f.append_flow(Flow(torch.ones(2, H, W), occlusion=Mask(
                    torch.zeros(1, H, W))), "flow_forward")
            frames.append(f.temporal())
        return _cat_batched(frames, axis_name="T")

    def getitem(self, idx: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        scene, fnames = self.items[idx]
        render = self.passes[0]
        frames = []
        for t, fname in enumerate(fnames):
            f = Frame(os.path.join(self.base, render, scene, fname))
            self._attach_labels(f, scene, fname, t, t == len(fnames) - 1)
            frames.append(f.temporal())
        return _cat_batched(frames, axis_name="T")

    def _occlusion(self, scene: str, fname: str):
        path = os.path.join(self.base, "occlusions", scene, fname)
        return Mask(path) if os.path.exists(path) else None


class SintelFlowDataset(SintelBaseDataset):
    """Optical flow: ``flow_forward`` with its occlusion on each frame but
    the last."""

    def _attach_labels(self, frame, scene, fname, t, is_last):
        if is_last:
            return
        stem = os.path.splitext(fname)[0]
        flow_path = os.path.join(self.base, "flow", scene, stem + ".flo")
        if not os.path.exists(flow_path):
            return
        frame.append_flow(Flow(flow_path,
                               occlusion=self._occlusion(scene, fname)),
                          "flow_forward")


def decode_sintel_disparity(path: str) -> torch.Tensor:
    """(H, W) float32 disparity of a Sintel disparity PNG: R * 4 + G / 64 +
    B / 16384 of its 8-bit channels."""
    from ..runtime import decode
    rgb = decode(path, "color").float()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return r * 4 + g / 64 + b / 16384


class SintelDisparityDataset(SintelBaseDataset):
    """Stereo disparity with its occlusion on every frame."""

    def _attach_labels(self, frame, scene, fname, t, is_last):
        disp_path = os.path.join(self.base, "disparities", scene, fname)
        if not os.path.exists(disp_path):
            return
        try:
            disp = decode_sintel_disparity(disp_path)
        except InvalidSampleError:
            return
        frame.append_disparity(Disparity(
            disp[None], occlusion=self._occlusion(scene, fname),
            disp_format="unsigned"))


class SintelMultiDataset(SintelFlowDataset, SintelDisparityDataset):
    """Flow and disparity together."""

    def _attach_labels(self, frame, scene, fname, t, is_last):
        SintelFlowDataset._attach_labels(self, frame, scene, fname, t,
                                         is_last)
        SintelDisparityDataset._attach_labels(self, frame, scene, fname, t,
                                              is_last)
