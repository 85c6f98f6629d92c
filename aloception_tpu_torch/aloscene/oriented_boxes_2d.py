"""OrientedBoxes2D: N x 5 rotated boxes [x, y, w, h, theta] (counterpart of
``aloception_tpu/aloscene/oriented_boxes_2d.py``). Corners and the pairwise
rotated IoU/GIoU run on the boxes' device through ``ops/rotated_iou.py``.
There is no ``_rotate``: rotating a frame carries its oriented boxes over
unchanged, as in the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..ops import rotated_iou as riou
from .augmented import AugmentedArray
from .labels import Labels


class OrientedBoxes2D(AugmentedArray):

    def __init__(self, x, absolute: bool = True,
                 labels: Union[dict, Labels, None] = None,
                 frame_size: Optional[Tuple[int, int]] = None,
                 names=("N", None), **kwargs):
        super().__init__(x, names=names, **kwargs)
        self.add_property("absolute", absolute)
        self.add_property("frame_size",
                          tuple(frame_size) if frame_size is not None else None)
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    def corners(self) -> torch.Tensor:
        """(N, 4, 2) corner coordinates."""
        return riou.box2corners(self.array)

    def rotated_iou_with(self, boxes2: "OrientedBoxes2D") -> torch.Tensor:
        """Pairwise rotated IoU (N, M)."""
        return riou.pairwise(riou.cal_iou, self.array, boxes2.array)

    def rotated_giou_with(self, boxes2: "OrientedBoxes2D") -> torch.Tensor:
        """Pairwise rotated GIoU (N, M)."""
        return riou.pairwise(riou.cal_giou, self.array, boxes2.array)[0]

    def _with_columns(self, updates) -> "OrientedBoxes2D":
        """Copy with columns replaced: ``updates`` maps a column index to a
        function of the old column."""
        cols = list(self.array.unbind(-1))
        for i, fn in updates.items():
            cols[i] = fn(cols[i])
        return self._with_array(torch.stack(cols, -1))

    def _flip(self, axis: int, frame_size):
        fs = frame_size or self.frame_size
        size = fs[axis] if (self.absolute and fs is not None) else 1.0
        return self._with_columns({1 - axis: lambda c: size - c,
                                   4: lambda c: -c})

    def _hflip(self, frame_size=None, **kw):
        return self._flip(1, frame_size)

    def _vflip(self, frame_size=None, **kw):
        return self._flip(0, frame_size)

    def _resize(self, size01, **kw):
        if not self.absolute:
            return self.clone()
        sy, sx = size01
        out = self._with_columns({0: lambda c: c * sx, 2: lambda c: c * sx,
                                 1: lambda c: c * sy, 3: lambda c: c * sy})
        if self.frame_size is not None:
            out.frame_size = (self.frame_size[0] * sy,
                              self.frame_size[1] * sx)
        return out

    def _crop(self, H_crop, W_crop, frame_size=None, **kw):
        fs = frame_size or self.frame_size or (1.0, 1.0)
        out = self._with_columns({0: lambda c: c - W_crop[0] * fs[1],
                                 1: lambda c: c - H_crop[0] * fs[0]})
        if self.frame_size is not None:
            out.frame_size = ((H_crop[1] - H_crop[0]) * fs[0],
                              (W_crop[1] - W_crop[0]) * fs[1])
        return out

    def _pad(self, offset_y, offset_x, frame_size=None, **kw):
        fs = frame_size or self.frame_size or (1.0, 1.0)
        return self._with_columns({0: lambda c: c + offset_x[0] * fs[1],
                                  1: lambda c: c + offset_y[0] * fs[0]})

    def _spatial_shift(self, sy, sx, **kw):
        fs = self.frame_size or (1.0, 1.0)
        return self._with_columns({0: lambda c: c + sx * fs[1],
                                  1: lambda c: c + sy * fs[0]})
