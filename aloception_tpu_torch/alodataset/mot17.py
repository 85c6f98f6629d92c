"""MOT17 multi-object tracking (counterpart of
``aloception_tpu/alodataset/mot17.py``; reference: alodataset/mot17.py:15).

On disk: ``<split>/<sequence>/{seqinfo.ini, img1/%06d.jpg, gt/gt.txt}``
with ``train`` for the train and val splits and ``test`` for test. A
gt.txt row is frame, track id, x, y, w, h, conf, class, visibility; rows
of conf 0 or a visibility under ``visibility_threshold`` are dropped.
getitem gives a Frame (T, C, H, W) of ``sequence_size`` frames
``sequence_skip + 1`` apart, each frame's ``boxes2d`` relative xcyc with
the track ids as ``Labels``.

``random_step`` re-strides a window with a step in 1..random_step, clamped
so that the window ends by the sequence's last frame, as the JAX dataset
does. The port draws the step per item from (``transform_seed`` or 0,
epoch, index) (``base_dataset.sample_generator``), where the JAX dataset
draws from numpy's global generator (ROADMAP §C).

``sample=True`` gives the JAX package's 4 deterministic items, from the same
numpy seeds.
"""

from __future__ import annotations

import configparser
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels
from ..aloscene.spatial import _cat_batched
from .base_dataset import BaseDataset, Split, sample_generator
from .mixins import SequenceMixin, SplitMixin


class Mot17(SequenceMixin, SplitMixin, BaseDataset):

    SPLIT_FOLDERS = {Split.TRAIN: "train", Split.VAL: "train",
                     Split.TEST: "test"}

    def __init__(self, split: Split = Split.TRAIN, sequence_size: int = 2,
                 detections_set="FRCNN", sample: bool = False,
                 validation_sequences: Optional[List[str]] = None,
                 training_sequences: Optional[List[str]] = None,
                 visibility_threshold: float = 0.0,
                 random_step: Optional[int] = None, **kwargs):
        """``detections_set``: one of, or a list of, {DPM, SDP, FRCNN} (a
        sequence is kept when its name holds one); ``validation_sequences``
        names the sequences of the val split (the train split takes the
        others); ``training_sequences`` restricts the train split."""
        self.split = split
        if isinstance(detections_set, str):
            detections_set = [detections_set]
        self.detections_set = detections_set
        self.visibility_threshold = visibility_threshold
        self.random_step = random_step
        super().__init__(name="mot17", sample=sample,
                         sequence_size=sequence_size, **kwargs)
        if sample:
            self.items = list(range(4))
            return
        self.mot_folder = os.path.join(self.dataset_dir,
                                       self.get_split_folder())
        self.items = []
        self.seq_len: Dict[str, int] = {}
        self.gt: Dict[str, Dict[int, List]] = {}
        for seq in sorted(os.listdir(self.mot_folder)):
            if not any(d in seq for d in detections_set):
                continue
            if validation_sequences is not None:
                in_val = any(v in seq for v in validation_sequences)
                if (split == Split.VAL) != in_val:
                    continue
            if training_sequences is not None and split == Split.TRAIN \
                    and not any(t in seq for t in training_sequences):
                continue
            info = configparser.ConfigParser()
            info.read(os.path.join(self.mot_folder, seq, "seqinfo.ini"))
            n = int(info["Sequence"]["seqLength"])
            self.seq_len[seq] = n
            self.gt[seq] = self._read_gt(
                os.path.join(self.mot_folder, seq, "gt", "gt.txt"))
            step = self.sequence_skip + 1
            span = (self.sequence_size - 1) * step
            for start in range(1, n + 1 - span):
                self.items.append((seq, [start + k * step
                                         for k in range(self.sequence_size)]))

    def _read_gt(self, path: str) -> Dict[int, List]:
        per_frame = defaultdict(list)
        if not os.path.exists(path):
            return per_frame
        with open(path) as f:
            for line in f:
                p = line.strip().split(",")
                frame_id, track = int(p[0]), int(p[1])
                x, y, w, h = map(float, p[2:6])
                conf = float(p[6])
                vis = float(p[8]) if len(p) > 8 else 1.0
                if conf == 0 or vis < self.visibility_threshold:
                    continue
                per_frame[frame_id].append((track, x, y, w, h))
        return per_frame

    def _frame_with_gt(self, seq: str, frame_id: int) -> Frame:
        frame = Frame(os.path.join(self.mot_folder, seq, "img1",
                                   f"{frame_id:06d}.jpg"))
        H, W = frame.HW
        boxes, tracks = [], []
        for track, x, y, w, h in self.gt.get(seq, {}).get(frame_id, []):
            boxes.append([(x + w / 2) / W, (y + h / 2) / H, w / W, h / H])
            tracks.append(track)
        frame.append_boxes2d(BoundingBoxes2D(
            torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 4)),
            "xcyc", False,
            labels=Labels(torch.from_numpy(np.asarray(tracks, np.float32)))))
        return frame

    def _getitem_sample(self, idx: int) -> Frame:
        rng = np.random.RandomState(5000 + idx)
        frames = []
        for t in range(self.sequence_size):
            f = Frame(torch.from_numpy(
                rng.uniform(0, 255, (3, 96, 128)).astype(np.float32)))
            xc = 0.3 + 0.05 * t
            f.append_boxes2d(BoundingBoxes2D(
                torch.tensor([[xc, 0.5, 0.2, 0.3]], dtype=torch.float32),
                "xcyc", False,
                labels=Labels(torch.tensor([7.0], dtype=torch.float32))))
            frames.append(f.temporal())
        return _cat_batched(frames, axis_name="T")

    def window(self, idx: int, step: Optional[int] = None) -> List[int]:
        """The frame ids of item ``idx``, re-strided by ``step`` (clamped to
        the sequence's last frame) when given."""
        seq, frame_ids = self.items[idx]
        if step is None or self.sequence_size <= 1:
            return frame_ids
        start = frame_ids[0]
        last = self.seq_len.get(seq, frame_ids[-1])
        if start + (self.sequence_size - 1) * step > last:
            step = max(1, (last - start) // max(1, self.sequence_size - 1))
        return [start + k * step for k in range(self.sequence_size)]

    def getitem(self, idx: int) -> Frame:
        return self._getitem(idx, 0)

    def _getitem(self, idx: int, epoch: int) -> Frame:
        if self.sample:
            return self._getitem_sample(idx)
        step = None
        if self.random_step is not None and self.sequence_size > 1:
            step = int(torch.randint(
                1, self.random_step + 1, (),
                generator=sample_generator(self.transform_seed or 0, epoch,
                                           idx)))
        seq = self.items[idx][0]
        return _cat_batched(
            [self._frame_with_gt(seq, fid).temporal()
             for fid in self.window(idx, step)], axis_name="T")
