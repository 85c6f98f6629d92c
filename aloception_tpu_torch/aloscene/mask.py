"""Mask: (N|1, H, W) float occupancy masks with optional Labels (counterpart
of ``aloception_tpu/aloscene/mask.py``). ``Mask(path)``
reads an image file as grey / 255, (1, H, W)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .labels import Labels
from .spatial import SpatialAugmentedArray


class Mask(SpatialAugmentedArray):

    def __init__(self, x, labels: Union[dict, Labels, None] = None,
                 names=("N", "H", "W"), **kwargs):
        if isinstance(x, str):
            from .io.mask import load_mask
            x = load_mask(x)
            names = ("N", "H", "W")
        super().__init__(x, names=names, **kwargs)
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    # colour of a label id (or index) in the masks' views
    _GLOBAL_COLOR_SET = np.random.RandomState(42).uniform(0, 1, (300, 3))

    def __get_view__(self, title=None, frame=None, frame_size=None,
                     **kwargs):
        """The masks' coloured overlay (mask.py:84-161), each mask in its
        label's colour (its index's without labels), summed and clipped;
        blended 0.6 / 0.4 onto ``frame`` (resized to it) when one is given.
        Computed on the host as one float32 product of the planes with
        their colours (JAX adds plane by plane in float64: within 1e-6)."""
        from .renderer import View, resize_view
        host = self.cpu()
        masks = host.as_numpy()
        if masks.ndim == 2:
            masks = masks[None]
        while masks.ndim > 3:
            masks = masks[0]
        H, W = masks.shape[-2:]
        labels = host.get_child("labels")
        lab = labels.as_numpy().astype(int) \
            if labels is not None and not isinstance(labels, dict) else None
        ids = np.array([lab[i] if lab is not None and i < len(lab) else i
                        for i in range(masks.shape[0])], int)
        colors = self._GLOBAL_COLOR_SET[ids % 300].astype(np.float32)
        overlay = np.clip(np.tensordot(masks.astype(np.float32, copy=False),
                                       colors, axes=(0, 0)), 0, 1)
        if frame is not None:
            if frame.shape[:2] != (H, W):
                overlay = resize_view(overlay, frame.shape[:2])
            return View(np.clip(frame * 0.6 + overlay * 0.4, 0, 1),
                        title=title)
        return View(overlay, title=title)

    def iou_with(self, mask2: "Mask", eps: float = 1e-6) -> torch.Tensor:
        """Pairwise IoU between two sets of masks -> (N1, N2)."""
        m1 = self.array.reshape(self.shape[0], -1).float()
        m2 = mask2.array.reshape(mask2.shape[0], -1).float()
        inter = m1 @ m2.T
        union = m1.sum(-1)[:, None] + m2.sum(-1)[None, :] - inter
        return inter / (union + eps)

    def mask2id(self, return_cats: bool = False, background_id: int = -1):
        """Collapse an (N, H, W) binary stack into an (H, W) int32 id map.
        Pixels covered by a mask (> 0.5) take the id (its label when the
        masks carry one set of labels, else its index) of the first mask of
        largest value; the others take ``background_id``."""
        if self.names[0] != "N":
            raise ValueError(f"mask2id needs an N-first mask, got {self.names}")
        masks = self.array
        n = masks.shape[0]
        labels = self.get_child("labels")
        if labels is not None and not isinstance(labels, dict):
            cats = labels.array.to(torch.int32)
        else:
            cats = torch.arange(n, dtype=torch.int32, device=self.device)
        if n == 0:
            out = torch.full(self.shape[-2:], background_id,
                             dtype=torch.int32, device=self.device)
        else:
            best, covered = masks.argmax(0), masks.amax(0) > 0.5
            out = torch.where(covered, cats[best],
                              torch.full_like(cats[best], background_id))
        return (out, cats) if return_cats else out
