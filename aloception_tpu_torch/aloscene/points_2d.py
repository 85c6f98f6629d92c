"""Points2D keypoints (counterpart of ``aloception_tpu/aloscene/points_2d.py``).

Formats ``xy``/``yx`` x absolute/relative, with the geometric op set:
hflip/vflip mirror coordinates, crop translates and drops the points that
fall outside (a data-dependent shape: one sync on the card), pad moves the
points or records ``padded_size``. There is no ``_rotate``: rotating a frame
carries its points over unchanged, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .augmented import AugmentedArray, const
from .labels import Labels

FORMATS = ("xy", "yx")


class Points2D(AugmentedArray):

    def __init__(self, x, points_format: str, absolute: bool,
                 labels: Union[dict, Labels, None] = None,
                 frame_size: Optional[Tuple[int, int]] = None,
                 names=("N", None), **kwargs):
        super().__init__(x, names=names, **kwargs)
        if points_format not in FORMATS:
            raise ValueError(f"format '{points_format}' not in {FORMATS}")
        if absolute and frame_size is None:
            raise ValueError("absolute points require frame_size")
        self.add_property("points_format", points_format)
        self.add_property("absolute", absolute)
        self.add_property("padded_size", None)
        self.add_property("frame_size",
                          tuple(frame_size) if frame_size is not None else None)
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    # format / position state ------------------------------------------------
    def xy(self) -> "Points2D":
        n = self.clone()
        if n.points_format == "xy":
            return n
        n.array = n.array.flip(-1)
        n.points_format = "xy"
        return n

    def yx(self) -> "Points2D":
        n = self.clone()
        if n.points_format == "yx":
            return n
        n.array = n.array.flip(-1)
        n.points_format = "yx"
        return n

    def get_with_format(self, fmt: str) -> "Points2D":
        return self.xy() if fmt == "xy" else self.yx()

    def _scale_vec(self, frame_size) -> torch.Tensor:
        h, w = frame_size
        return const([w, h] if self.points_format == "xy" else [h, w],
                     self.array)

    def abs_pos(self, frame_size: Tuple[int, int]) -> "Points2D":
        n = self.clone()
        frame_size = tuple(frame_size)
        if n.absolute and frame_size != n.frame_size:
            n.array = n.array / n._scale_vec(n.frame_size)
            n.absolute = False
        if not n.absolute:
            n.array = n.array * n._scale_vec(frame_size)
            n.frame_size = frame_size
            n.absolute = True
        return n

    def rel_pos(self) -> "Points2D":
        n = self.clone()
        if n.absolute:
            n.array = n.array / n._scale_vec(n.frame_size)
        n.absolute = False
        n.frame_size = None
        return n

    # geometric ops ------------------------------------------------------
    def _in_rel_xy(self, fn, keep_inside: bool = False,
                   frame_size: Optional[Tuple[float, float]] = None):
        """Apply ``fn(x, y) -> (x, y)`` to the relative xy coordinates, drop
        the points outside [0, 1]^2 if ``keep_inside``, and return to this
        state (absolute in ``frame_size``, default the current one)."""
        absolute, fmt = self.absolute, self.points_format
        frame_size = frame_size or self.frame_size
        pts = self.rel_pos().xy()
        x, y = fn(pts.array[..., 0], pts.array[..., 1])
        pts.array = torch.stack([x, y], -1)
        if keep_inside:
            pts = pts[(x >= 0) & (x <= 1) & (y >= 0) & (y <= 1)]
        if absolute:
            pts = pts.abs_pos(frame_size)
        return pts.get_with_format(fmt)

    def _hflip(self, **kwargs):
        return self._in_rel_xy(lambda x, y: (1.0 - x, y))

    def _vflip(self, **kwargs):
        return self._in_rel_xy(lambda x, y: (x, 1.0 - y))

    def _resize(self, size01, **kwargs):
        pts = self.clone()
        if not pts.absolute:
            return pts
        abs_size = tuple(s * fs for s, fs in zip(size01, pts.frame_size))
        return pts.abs_pos(abs_size)

    def _crop(self, H_crop, W_crop, **kwargs):
        if self.padded_size is not None:
            raise RuntimeError("cannot crop padded points; "
                               "fit_to_padded_size() first")
        (y0, y1), (x0, x1) = H_crop, W_crop
        frame_size = None if self.frame_size is None else (
            (y1 - y0) * self.frame_size[0], (x1 - x0) * self.frame_size[1])
        return self._in_rel_xy(
            lambda x, y: ((x - x0) / (x1 - x0), (y - y0) / (y1 - y0)),
            keep_inside=True, frame_size=frame_size)

    def _pad(self, offset_y, offset_x, pad_points2d: bool = True, **kwargs):
        if not pad_points2d:
            n = self.clone()
            if n.padded_size is None:
                n.padded_size = ((offset_y[0], offset_y[1]),
                                 (offset_x[0], offset_x[1]))
            else:
                ps = n.padded_size
                n.padded_size = ((ps[0][0] + offset_y[0], ps[0][1] + offset_y[1]),
                                 (ps[1][0] + offset_x[0], ps[1][1] + offset_x[1]))
            return n
        sy = 1.0 + offset_y[0] + offset_y[1]
        sx = 1.0 + offset_x[0] + offset_x[1]
        frame_size = None if self.frame_size is None else (
            self.frame_size[0] * sy, self.frame_size[1] * sx)
        return self._in_rel_xy(
            lambda x, y: ((x + offset_x[0]) / sx, (y + offset_y[0]) / sy),
            frame_size=frame_size)

    def fit_to_padded_size(self) -> "Points2D":
        if self.padded_size is None:
            raise RuntimeError("no padded_size recorded")
        ps = self.padded_size
        n = self.remove_padding()
        return n._pad((ps[0][0], ps[0][1]), (ps[1][0], ps[1][1]),
                      pad_points2d=True)

    def remove_padding(self) -> "Points2D":
        n = self.clone()
        n.padded_size = None
        return n

    def _spatial_shift(self, shift_y, shift_x, **kwargs):
        return self._in_rel_xy(lambda x, y: (x + shift_x, y + shift_y),
                               keep_inside=True)

    def as_points(self, points: "Points2D") -> "Points2D":
        n = self.clone()
        if points.absolute and not n.absolute:
            n = n.abs_pos(points.frame_size)
        elif not points.absolute and n.absolute:
            n = n.rel_pos()
        return n.get_with_format(points.points_format)
