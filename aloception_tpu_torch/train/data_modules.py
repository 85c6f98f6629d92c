"""Data modules: datasets -> model-ready batches (counterpart of
``aloception_tpu/train/data_modules.py``): ``CocoDetection2Detr`` for the
detectors and the panoptic head, ``Data2RAFT`` for RAFT.

``size=None`` is the reference's multi-scale geometry: each frame is flipped
with p = 0.5, then either resized with its aspect ratio to a shorter side
drawn from ``REFERENCE_SCALES`` (longer side at most 1333), or resized to a
shorter side of 400/500/600, cropped to a random 384-600 square-ish region
and resized as before; validation takes a shorter side of 800. A batch is
padded to the smallest of ``MULTISCALE_BUCKETS`` that holds it. With a fixed
``size`` (H, W): flip, resize with the aspect ratio to a shorter side drawn
from ``scales``, resize to ``size``. Frames are normalised for the ResNet.
``sample=True`` reads the synthetic COCO sample; without it, COCO on disk
(``CocoDetectionDataset``, whose ``dataset_dir=`` and other arguments pass
through ``dataset_kwargs``), its frames made by ``num_workers`` threads.
With ``return_masks`` the frames carry their objects' ``segmentation``
Masks, which flip, crop and resize (bilinearly, so a resized mask is soft)
with them; a batch keeps them as a per-frame list.

``Data2RAFT`` reads FlyingChairs2, FlyingThings3D, ChairsSDHom or Sintel,
on disk or as the offline samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import aloscene
from ..alodataset import (CocoBaseDataset, CocoDetectionDataset,
                          FlyingChairs2Dataset, SintelFlowDataset, Split)
from ..alodataset.flying_things import (ChairsSDHomDataset,
                                        FlyingThings3DSubsetDataset)
from ..alodataset import transforms as T
from ..models.detr.criterion import targets_from_frames

# the reference's multi-scale shorter sides (data2detr.py)
REFERENCE_SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]

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
    """COCO -> DETR batches, at the multi-scale geometry (``size=None``) or
    a fixed ``size`` (H, W). ``seed`` seeds the loaders' shuffle and the
    transforms: each sample draws from a generator of (seed, epoch, index)
    with a copy of the transforms of its own, so the batches do not depend
    on the worker threads."""

    def __init__(self, batch_size: int = 2, num_workers: int = 2,
                 train_on_val: bool = False, sample: bool = False,
                 size: Optional[Tuple[int, int]] = None,
                 scales: Optional[Sequence[int]] = None,
                 max_targets: int = 100,
                 classes: Optional[List[str]] = None, seed: int = 0,
                 return_masks: bool = False, **dataset_kwargs):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.size = None if size is None else tuple(size)
        self.max_targets = max_targets
        self.seed = seed
        # the trees' generator: a sample's copy draws from one of its own
        g = torch.Generator().manual_seed(seed)
        if size is None:
            scales = list(scales or REFERENCE_SCALES)
            max_size = 1333
            train = T.Compose([
                T.RandomHorizontalFlip(0.5, generator=g),
                T.RandomSelect(
                    T.RandomResizeWithAspectRatio(scales, max_size=max_size,
                                                  generator=g),
                    T.Compose([
                        T.RandomResizeWithAspectRatio([400, 500, 600],
                                                      generator=g),
                        T.RandomSizeCrop(384, 600, generator=g),
                        T.RandomResizeWithAspectRatio(scales,
                                                      max_size=max_size,
                                                      generator=g),
                    ], generator=g), generator=g),
            ], generator=g)
            val = T.RandomResizeWithAspectRatio([scales[-1]],
                                                max_size=max_size,
                                                generator=g)
        else:
            scales = list(scales or (392, 416, 448, 480))
            train = T.Compose([
                T.RandomHorizontalFlip(0.5, generator=g),
                T.RandomResizeWithAspectRatio(
                    scales, max_size=int(self.size[1] * 1.2), generator=g),
                T.Resize(self.size, generator=g)], generator=g)
            val = T.Resize(self.size, generator=g)
        self.train_transform, self.val_transform = train, val

        def make(split, tfn):
            def transform_fn(frame, generator):
                return tfn.with_generator(generator)(frame).norm_resnet()
            if sample:
                return CocoBaseDataset(
                    sample=True, transform_fn=transform_fn,
                    transform_seed=seed, return_masks=return_masks)
            return CocoDetectionDataset(
                split=split, classes=classes, return_masks=return_masks,
                transform_fn=transform_fn, transform_seed=seed,
                **dataset_kwargs)

        self.train_dataset = make(
            Split.VAL if train_on_val else Split.TRAIN, train)
        self.val_dataset = make(Split.VAL, val)
        self.label_names = self.train_dataset.labels_names

    def train_dataloader(self):
        return self.train_dataset.train_loader(
            batch_size=self.batch_size, num_workers=self.num_workers,
            seed=self.seed)

    def val_dataloader(self):
        return self.val_dataset.train_loader(
            batch_size=self.batch_size, num_workers=self.num_workers,
            shuffle=False)

    def prepare_batch(self, frames_list: List, training: bool = True) -> Dict:
        """list[Frame] -> {"inputs": (images (B, H, W, 3), mask (B, H, W),
        1 = padded), "targets": padded target tensors, "frames": the batch},
        all on the CPU. Multi-scale batches are padded to their bucket."""
        size = self.size
        if size is None:
            size = pick_bucket(max(f.H for f in frames_list),
                               max(f.W for f in frames_list))
        batched = aloscene.batch_list(frames_list, size=size)
        images = batched.as_layout(("B", "H", "W", "C")).float().contiguous()
        mask = batched.mask.array[:, 0].float().contiguous()
        targets = targets_from_frames(batched, max_targets=self.max_targets)
        return {"inputs": (images, mask), "targets": targets,
                "frames": batched}


class Data2RAFT:
    """Flow datasets -> RAFT batches; ``dataset`` picks "chairs"
    (FlyingChairs2), "things" (FlyingThings3D subset), "sdhom"
    (ChairsSDHom) or "sintel", on disk (TRAIN and VAL splits; ``**
    dataset_kwargs``, e.g. ``dataset_dir=``, pass through) or as the offline
    samples (``sample=True``, the train split twice). Samples are made by
    ``num_workers`` threads. ``size`` is taken and not used, as in the JAX
    package: batches keep the frames' own size. ``seed`` seeds the train
    loader's shuffle."""

    DATASETS = ("chairs", "things", "sdhom", "sintel")

    def __init__(self, batch_size: int = 2, num_workers: int = 2,
                 sample: bool = False, size: Tuple[int, int] = (368, 496),
                 dataset: str = "chairs", seed: int = 0, **dataset_kwargs):
        if dataset not in self.DATASETS:
            raise ValueError(f"dataset must be one of {self.DATASETS}")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.size = size
        self.seed = seed
        cls = {"chairs": FlyingChairs2Dataset,
               "things": FlyingThings3DSubsetDataset,
               "sdhom": ChairsSDHomDataset,
               "sintel": SintelFlowDataset}[dataset]
        self.train_dataset = cls(split=Split.TRAIN, sample=sample,
                                 **dataset_kwargs)
        self.val_dataset = cls(split=Split.TRAIN if sample else Split.VAL,
                               sample=sample, **dataset_kwargs)

    def train_dataloader(self):
        return self.train_dataset.train_loader(
            batch_size=self.batch_size, num_workers=self.num_workers,
            seed=self.seed)

    def val_dataloader(self):
        return self.val_dataset.train_loader(
            batch_size=self.batch_size, num_workers=self.num_workers,
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
