"""Frame: the image type with a normalization state machine and label
children (counterpart of ``aloception_tpu/aloscene/frame.py``).

A Frame holds pixel data in any named layout (default CHW; ``as_layout``
exports BHWC to models) and the full child set: points2d/3d, boxes2d/3d,
flow, disparity, depth, segmentation, labels, pose, scene_flow.

Normalization states: "255", "01", "minmax_sym", or a named mean/std norm
(e.g. "resnet"). Integer payloads are converted in float32. ``Frame(path)``
decodes an image file with ``runtime.decode`` (CHW RGB, "255").
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .augmented import const
from .spatial import SpatialAugmentedArray

RESNET_MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


class Frame(SpatialAugmentedArray):

    def __init__(self, x, boxes2d=None, boxes3d=None, labels=None, flow=None,
                 segmentation=None, disparity=None, points2d=None,
                 points3d=None, depth=None, pose=None, scene_flow=None,
                 normalization: str = "255", mean_std: Optional[Tuple] = None,
                 names=("C", "H", "W"), **kwargs):
        if isinstance(x, str):
            from .io.image import load_image
            x = load_image(x)
        super().__init__(x, names=names, **kwargs)
        for name, value, mergeable in (
                ("points2d", points2d, False), ("points3d", points3d, False),
                ("boxes2d", boxes2d, False), ("boxes3d", boxes3d, False),
                ("flow", flow, False), ("disparity", disparity, True),
                ("depth", depth, True), ("segmentation", segmentation, False),
                ("labels", labels, True), ("pose", pose, True),
                ("scene_flow", scene_flow, False)):
            self.add_child(name, value, align_dim=["B", "T"],
                           mergeable=mergeable)

        if mean_std is not None:
            mean_std = (tuple(mean_std[0]), tuple(mean_std[1]))
        if normalization in ("255", "01", "minmax_sym"):
            if mean_std is not None:
                raise ValueError(f"normalization '{normalization}' takes no "
                                 "mean_std")
        elif mean_std is None:
            raise ValueError(f"named normalization '{normalization}' requires "
                             "mean_std")
        self.add_property("normalization", normalization)
        self.add_property("mean_std", mean_std)

    def append_boxes2d(self, boxes, name=None):
        self._append_child("boxes2d", boxes, name)

    def append_boxes3d(self, boxes, name=None):
        self._append_child("boxes3d", boxes, name)

    def append_points2d(self, pts, name=None):
        self._append_child("points2d", pts, name)

    def append_points3d(self, pts, name=None):
        self._append_child("points3d", pts, name)

    def append_flow(self, flow, name=None):
        self._append_child("flow", flow, name)

    def append_disparity(self, disp, name=None):
        self._append_child("disparity", disp, name)

    def append_depth(self, depth, name=None):
        self._append_child("depth", depth, name)

    def append_segmentation(self, seg, name=None):
        self._append_child("segmentation", seg, name)

    def append_labels(self, labels, name=None):
        self._append_child("labels", labels, name)

    def append_pose(self, pose, name=None):
        self._append_child("pose", pose, name)

    def append_scene_flow(self, sf, name=None):
        self._append_child("scene_flow", sf, name)

    # ------------------------------------------------------------------
    # normalization state machine
    # ------------------------------------------------------------------
    def _mean_std_arrays(self, mean_std) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 mean and std on the payload's device, shaped to broadcast
        over its C dim."""
        n_shape = [1] * self.ndim
        n_shape[self.dim_idx("C")] = len(mean_std[0])
        return (const(mean_std[0], self.array).reshape(n_shape),
                const(mean_std[1], self.array).reshape(n_shape))

    def _renorm(self, array, normalization, mean_std=None) -> "Frame":
        n = self._with_array(array)
        n.normalization = normalization
        n.mean_std = mean_std
        return n

    def norm01(self) -> "Frame":
        t = self
        if t.normalization == "01":
            return t.clone()
        if t.normalization == "255":
            return t._renorm(t.array / 255.0, "01")
        if t.normalization == "minmax_sym":
            return t._renorm((t.array + 1.0) / 2.0, "01")
        if t.mean_std is not None:
            mean, std = t._mean_std_arrays(t.mean_std)
            return t._renorm(t.array * std + mean, "01")
        raise ValueError(f"cannot convert from {t.normalization} to 01")

    def norm255(self) -> "Frame":
        t = self
        if t.normalization == "255":
            return t.clone()
        if t.normalization == "01":
            return t._renorm(t.array * 255.0, "255")
        if t.normalization == "minmax_sym":
            return t._renorm((t.array + 1.0) * 255.0 / 2.0, "255")
        if t.mean_std is not None:
            mean, std = t._mean_std_arrays(t.mean_std)
            return t._renorm((t.array * std + mean) * 255.0, "255")
        raise ValueError(f"cannot convert from {t.normalization} to 255")

    def norm_minmax_sym(self) -> "Frame":
        t = self
        if t.normalization == "minmax_sym":
            return t.clone()
        if t.normalization == "01":
            return t._renorm(2 * t.array - 1.0, "minmax_sym")
        if t.normalization == "255":
            return t._renorm(2 * (t.array / 255.0) - 1.0, "minmax_sym")
        if t.mean_std is not None:
            return t.norm01().norm_minmax_sym()
        raise ValueError(f"cannot convert from {t.normalization} to "
                         "minmax_sym")

    def mean_std_norm(self, mean, std, name: str) -> "Frame":
        t = self
        mean, std = tuple(mean), tuple(std)
        if t.mean_std is not None and t.mean_std == (mean, std):
            return t.clone()
        t01 = t if t.normalization == "01" else t.norm01()
        mean_a, std_a = t01._mean_std_arrays((mean, std))
        return t01._renorm((t01.array - mean_a) / std_a, name, (mean, std))

    def norm_resnet(self) -> "Frame":
        return self.mean_std_norm(*RESNET_MEAN_STD, name="resnet")

    def norm_as(self, target: "Frame") -> "Frame":
        if target.normalization == "01":
            return self.norm01()
        if target.normalization == "255":
            return self.norm255()
        if target.normalization == "minmax_sym":
            return self.norm_minmax_sym()
        if target.mean_std is not None:
            return self.mean_std_norm(*target.mean_std,
                                      name=target.normalization)
        raise ValueError(f"cannot match normalization {target.normalization}")

    def __get_view__(self, title=None, **kwargs):
        """(frame.py:550) the norm01 HWC image of the first item, computed
        on the host."""
        from .renderer import View
        from .spatial import _hwc_first
        f = self.cpu().norm01()
        return View(_hwc_first(f, f.as_numpy()), title=title)

    def as_image(self, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        """(..., H, W, C) image in the 0-255 range, cast to ``dtype``."""
        f = self.norm255()
        perm = [f.dim_idx("H"), f.dim_idx("W"), f.dim_idx("C")]
        lead = [i for i in range(f.ndim) if i not in perm]
        return f.array.permute(lead + perm).to(dtype)

    # ------------------------------------------------------------------
    # normalization-aware geometric overrides
    # ------------------------------------------------------------------
    _PAD_VALUES = {"01": 0.0, "255": 0.0, "minmax_sym": -1.0}

    def _pad(self, offset_y, offset_x, **kwargs):
        """Padded pixels hold black in the frame's normalization; for a
        mean/std norm that is (0 - mean) / std per channel."""
        if self.normalization in self._PAD_VALUES:
            return self._padded(offset_y, offset_x,
                                self._PAD_VALUES[self.normalization])
        if self.mean_std is not None:
            mean, std = self._mean_std_arrays(self.mean_std)
            return self._padded(offset_y, offset_x, (0.0 - mean) / std)
        raise ValueError(f"_pad unsupported for normalization "
                         f"{self.normalization}")

    def _spatial_shift(self, shift_y, shift_x, **kwargs):
        """Roll and fill the uncovered band with the per-channel mean, taken
        in float32 and cast to the payload's dtype (integer payloads
        truncate, as numpy's assignment does)."""
        c_idx = self.dim_idx("C")
        mean = self.array.mean([i for i in range(self.ndim) if i != c_idx],
                               keepdim=True, dtype=torch.float32)
        return self._shifted(shift_y, shift_x, mean)
