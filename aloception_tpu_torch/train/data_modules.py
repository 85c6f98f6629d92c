"""Data modules: datasets -> model-ready batches (counterpart of
``aloception_tpu/train/data_modules.py``): ``CocoDetection2Detr`` for the
detectors and the panoptic head, ``Data2RAFT`` for RAFT.

Fixed-size training only: every frame is flipped with p = 0.5, resized with
its aspect ratio to a shorter side drawn from ``scales``, then resized to
``size``, and normalised for the ResNet. The reference's multi-scale
geometry (``size=None``) and COCO on disk wait in ROADMAP A10. With
``return_masks`` the frames carry their objects' ``segmentation`` Masks,
which flip and resize (bilinearly, so a resized mask is soft) with them;
a batch keeps them as a per-frame list.

``Data2RAFT`` reads the offline synthetic FlyingChairs2 and Sintel samples;
FlyingThings3D, ChairsSDHom and the datasets on disk wait in ROADMAP A10.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import aloscene
from ..alodataset import (CocoBaseDataset, FlyingChairs2Dataset,
                          SintelFlowDataset)
from ..alodataset import transforms as T
from ..models.detr.criterion import targets_from_frames

# Canonical padded batch shapes of multi-scale training, (short, long),
# multiples of 64, as in the JAX package: every shape its scales (shorter
# side 480-800, longer <= 1333) give fits one of them or its transpose.
MULTISCALE_BUCKETS = ((512, 768), (512, 1344), (704, 960), (704, 1344),
                      (832, 1088), (832, 1344))


def pick_bucket(max_h: int, max_w: int,
                buckets=MULTISCALE_BUCKETS) -> Tuple[int, int]:
    """Smallest bucket (by area) covering (max_h, max_w), trying both
    orientations; the 64-rounded exact shape if none fits."""
    best = None
    for s, l in buckets:
        for bh, bw in ((s, l), (l, s)):
            if bh >= max_h and bw >= max_w:
                if best is None or bh * bw < best[0] * best[1]:
                    best = (bh, bw)
    if best is None:
        best = (-(-max_h // 64) * 64, -(-max_w // 64) * 64)
    return best


class CocoDetection2Detr:
    """COCO -> DETR batches at a fixed ``size`` (H, W). ``seed`` seeds the
    transforms' generator and the loaders' shuffle."""

    def __init__(self, batch_size: int = 2, sample: bool = False,
                 size: Optional[Tuple[int, int]] = (480, 640),
                 scales: Optional[Sequence[int]] = None,
                 max_targets: int = 100, seed: int = 0,
                 return_masks: bool = False):
        if size is None:
            raise NotImplementedError(
                "multi-scale training (size=None) is not ported yet (ROADMAP "
                "A10); pass a fixed size")
        if not sample:
            raise NotImplementedError(
                "COCO on disk is not ported yet (ROADMAP A10); pass "
                "sample=True")
        self.batch_size = batch_size
        self.size = tuple(size)
        self.max_targets = max_targets
        self.seed = seed
        self.generator = torch.Generator().manual_seed(seed)
        scales = list(scales or (392, 416, 448, 480))
        train = T.Compose([
            T.RandomHorizontalFlip(0.5, generator=self.generator),
            T.RandomResizeWithAspectRatio(scales, int(self.size[1] * 1.2),
                                          generator=self.generator),
            T.Resize(self.size)])
        val = T.Resize(self.size)
        self.train_dataset = CocoBaseDataset(
            sample=True, transform_fn=lambda f: train(f).norm_resnet(),
            return_masks=return_masks)
        self.val_dataset = CocoBaseDataset(
            sample=True, transform_fn=lambda f: val(f).norm_resnet(),
            return_masks=return_masks)
        self.label_names = self.train_dataset.labels_names

    def train_dataloader(self):
        return self.train_dataset.train_loader(batch_size=self.batch_size,
                                               seed=self.seed)

    def val_dataloader(self):
        return self.val_dataset.train_loader(batch_size=self.batch_size,
                                             shuffle=False)

    def prepare_batch(self, frames_list: List, training: bool = True) -> Dict:
        """list[Frame] -> {"inputs": (images (B, H, W, 3), mask (B, H, W),
        1 = padded), "targets": padded target tensors, "frames": the batch},
        all on the CPU."""
        batched = aloscene.batch_list(frames_list, size=self.size)
        images = batched.as_layout(("B", "H", "W", "C")).float().contiguous()
        mask = batched.mask.array[:, 0].float().contiguous()
        targets = targets_from_frames(batched, max_targets=self.max_targets)
        return {"inputs": (images, mask), "targets": targets,
                "frames": batched}


class Data2RAFT:
    """Flow datasets -> RAFT batches; ``dataset`` picks "chairs" or
    "sintel" (the offline samples; "things" and "sdhom" wait in ROADMAP
    A10). ``size`` is taken and not used, as in the JAX package: the
    samples' frames are 96x128. ``seed`` seeds the train loader's
    shuffle."""

    DATASETS = ("chairs", "things", "sdhom", "sintel")

    def __init__(self, batch_size: int = 2, sample: bool = False,
                 size: Tuple[int, int] = (368, 496), dataset: str = "chairs",
                 seed: int = 0):
        if dataset not in self.DATASETS:
            raise ValueError(f"dataset must be one of {self.DATASETS}")
        if dataset in ("things", "sdhom"):
            raise NotImplementedError(
                f"the {dataset} dataset is not ported yet (ROADMAP A10)")
        self.batch_size = batch_size
        self.size = size
        self.seed = seed
        # the samples have one split: validation reads the train pairs, as
        # the JAX package's sample mode does
        self.train_dataset = (FlyingChairs2Dataset if dataset == "chairs"
                              else SintelFlowDataset)(sample=sample)
        self.val_dataset = self.train_dataset

    def train_dataloader(self):
        return self.train_dataset.train_loader(batch_size=self.batch_size,
                                               seed=self.seed)

    def val_dataloader(self):
        return self.val_dataset.train_loader(batch_size=self.batch_size,
                                             shuffle=False)

    def prepare_batch(self, frames_list: List, training: bool = True) -> Dict:
        """T=2 Frames -> {"inputs": (frame1, frame2) (B, 3, H, W) in
        ``minmax_sym``, "targets": {"flow" (B, 2, H, W), "valid" (B, H, W) =
        1 - occlusion}}, on the CPU."""
        f1s, f2s, flows, valids = [], [], [], []
        for frames in frames_list:
            frames = frames.norm_minmax_sym()
            f1, f2 = frames[0], frames[1]
            flow = f1.get_child("flow")
            if isinstance(flow, dict):
                flow = flow.get("flow_forward", next(iter(flow.values())))
            occ = flow.get_child("occlusion")
            valid = torch.ones(flow.shape[1:]) if occ is None \
                or isinstance(occ, dict) else 1.0 - occ.array[0].float()
            f1s.append(f1.as_layout(("C", "H", "W")).float())
            f2s.append(f2.as_layout(("C", "H", "W")).float())
            flows.append(flow.array.float())
            valids.append(valid)
        return {"inputs": (torch.stack(f1s), torch.stack(f2s)),
                "targets": {"flow": torch.stack(flows),
                            "valid": torch.stack(valids)}}
