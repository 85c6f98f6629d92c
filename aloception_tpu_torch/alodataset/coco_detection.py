"""COCO detection, the offline synthetic sample (counterpart of
``aloception_tpu/alodataset/coco_detection.py``).

``sample=True`` gives the JAX package's 12 deterministic synthetic frames
(coloured rectangles as objects on noise), made from the same numpy seeds, so
the two packages give the same images, boxes, labels and, with
``return_masks``, per-object segmentation masks for an index. COCO on disk
waits in ROADMAP A10.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels, Mask


class CocoBaseDataset:
    """getitem -> Frame (CHW float32, normalization "255") with boxes2d
    (relative xcyc) carrying ``Labels`` with ``labels_names`` and, with
    ``return_masks``, a ``segmentation`` child: a (N, H, W) ``Mask`` of the
    objects, with the same ``Labels``."""

    SAMPLE_CLASSES = ("person", "car", "dog", "chair")

    def __init__(self, sample: bool = False,
                 transform_fn: Optional[Callable] = None,
                 return_masks: bool = False):
        if not sample:
            raise NotImplementedError(
                "COCO on disk is not ported yet (ROADMAP A10); pass "
                "sample=True")
        self.return_masks = return_masks
        self.transform_fn = transform_fn
        self.items = list(range(12))
        self.labels_names = list(self.SAMPLE_CLASSES)

    def __len__(self) -> int:
        return len(self.items)

    def getitem(self, idx: int) -> Frame:
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
        lab = Labels(torch.tensor(labels, dtype=torch.float32),
                     labels_names=self.labels_names)
        frame.append_boxes2d(BoundingBoxes2D(
            torch.tensor(np.asarray(boxes, np.float32)), boxes_format="xcyc",
            absolute=False, labels=lab))
        if self.return_masks:
            frame.append_segmentation(Mask(torch.from_numpy(np.stack(masks)),
                                           labels=lab.clone()))
        return frame

    def __getitem__(self, idx: int) -> Frame:
        frame = self.getitem(idx)
        return frame if self.transform_fn is None else self.transform_fn(frame)

    def train_loader(self, batch_size: int = 1, shuffle: bool = True,
                     seed: Optional[int] = None, drop_last: bool = True
                     ) -> "Loader":
        """Re-iterable loader of lists of frames (batched on the card later
        by ``batch_list``), reshuffled each epoch."""
        return Loader(self, batch_size, shuffle, seed, drop_last)


class Loader:
    """Batches of ``dataset`` items as lists, in an order shuffled by numpy
    from ``seed + epoch`` (the JAX package's loader order). Items are made
    in the calling thread."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 seed: Optional[int], drop_last: bool):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[List]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(None if self.seed is None
                                  else self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for i in range(len(self)):
            yield [self.dataset[int(k)]
                   for k in order[i * self.batch_size:
                                  (i + 1) * self.batch_size]]
