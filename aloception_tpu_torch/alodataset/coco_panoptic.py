"""COCO panoptic, the offline synthetic sample (counterpart of
``aloception_tpu/alodataset/coco_panoptic.py``).

A panoptic annotation is an id-encoded PNG (id = R + 256 G + 256^2 B, see
``rgb2id``/``id2rgb``) with per-segment category ids, and a categories
table telling things from stuff (``isthing``). ``sample=True`` gives the
JAX package's 8 synthetic frames, made from the same numpy seeds: two stuff
half-planes (sky, road) and 1-2 thing rectangles, each a segment with its
box. COCO panoptic on disk waits in ROADMAP A10.
"""

from __future__ import annotations

import numpy as np
import torch

from ..aloscene import BoundingBoxes2D, Frame, Labels, Mask


def rgb2id(png: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> (H, W) uint32 segment ids, id = R + 256 G + 256^2 B."""
    png = png.astype(np.uint32)
    return png[..., 0] + 256 * png[..., 1] + 256 * 256 * png[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Inverse of ``rgb2id``: segment ids -> (H, W, 3) uint8 RGB."""
    ids = ids.astype(np.uint32)
    return np.stack([ids % 256, (ids // 256) % 256, ids // (256 * 256)],
                    axis=-1).astype(np.uint8)


class CocoPanopticDataset:
    """getitem -> Frame (CHW float32, normalization "255") with a
    ``segmentation`` (N, H, W) ``Mask`` of its segments and their boxes2d
    (relative xcyc), both with ``Labels`` carrying ``labels_names``.
    ``isthing`` maps each category id to True (thing) or False (stuff)."""

    SAMPLE_CLASSES = ("person", "car", "sky", "road")
    SAMPLE_ISTHING = (True, True, False, False)

    def __init__(self, sample: bool = False):
        if not sample:
            raise NotImplementedError(
                "COCO panoptic on disk is not ported yet (ROADMAP A10); pass "
                "sample=True")
        self.items = list(range(8))
        self.labels_names = list(self.SAMPLE_CLASSES)
        self.isthing = dict(enumerate(self.SAMPLE_ISTHING))

    def __len__(self) -> int:
        return len(self.items)

    def getitem(self, idx: int) -> Frame:
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
