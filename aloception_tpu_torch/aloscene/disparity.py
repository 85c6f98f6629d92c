"""Disparity maps, signed or unsigned, with depth conversion (counterpart of
``aloception_tpu/aloscene/disparity.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .camera_calib import per_item
from .mask import Mask
from .spatial import SpatialAugmentedArray


class Disparity(SpatialAugmentedArray):
    """Stereo disparity. ``disp_format``: "unsigned" (distance in pixels)
    or "signed" (relative offset; needs ``camera_side``). Resize scales the
    values by the width ratio; hflip negates a signed disparity and swaps
    ``camera_side``. The constructor checks an unsigned payload for
    negative values (one sync on the card)."""

    def __init__(self, x, occlusion: Optional[Mask] = None,
                 disp_format: str = "unsigned", png_negate: Optional[bool] = None,
                 names=("C", "H", "W"), **kwargs):
        if isinstance(x, str):
            from .io.disparity import load_disp
            x = load_disp(x, png_negate)
            names = ("C", "H", "W")
        super().__init__(x, names=names, **kwargs)
        if disp_format not in ("signed", "unsigned"):
            raise ValueError(f"unknown disparity format {disp_format!r}")
        self.add_child("occlusion", occlusion, align_dim=["B", "T"],
                       mergeable=True)
        self.add_property("disp_format", disp_format)
        if disp_format == "unsigned" and bool((self.array < 0).any()):
            raise ValueError("unsigned disparity must be positive")
        if disp_format == "signed" and self.camera_side is None:
            raise ValueError("signed disparity requires camera_side")

    def append_occlusion(self, occlusion: Mask, name: Optional[str] = None):
        self._append_child("occlusion", occlusion, name)

    def __get_view__(self, title=None, min_disp=None, max_disp=None,
                     cmap="nipy_spectral", **kwargs):
        """The colour-mapped |disparity| of the first item, from
        ``min_disp`` (the least value) to ``max_disp`` (the largest).
        Computed on the host."""
        from .renderer import View
        from .renderer.colormap import apply_colormap
        arr = np.abs(self.cpu().as_numpy())
        while arr.ndim > 2:
            arr = arr[0]
        lo = min_disp if min_disp is not None else arr.min()
        hi = max_disp if max_disp is not None else max(arr.max(), lo + 1e-6)
        norm = np.clip((arr - lo) / (hi - lo), 0, 1)
        return View(apply_colormap(norm, cmap).astype(np.float32),
                    title=title)

    def _resize(self, size01, **kwargs):
        W0 = self.W
        out = super()._resize(size01, **kwargs)
        return out._with_array(out.array * (out.W / W0))

    def _hflip(self, **kwargs):
        out = super()._hflip(**kwargs)
        if self.disp_format == "signed":
            out = out._with_array(-out.array)
        opposite = {"left": "right", "right": "left", None: None}
        out.camera_side = opposite[out.camera_side]
        return out

    def unsigned(self) -> "Disparity":
        d = self.clone()
        if d.disp_format == "unsigned":
            return d
        d.disp_format = "unsigned"
        d.array = d.array.abs()
        return d

    def signed(self, camera_side: Optional[str] = None) -> "Disparity":
        d = self.clone()
        if d.disp_format == "signed":
            return d
        camera_side = camera_side if camera_side is not None \
            else d.camera_side
        if camera_side is None:
            raise ValueError("camera_side required to sign disparity")
        d.disp_format = "signed"
        if camera_side == "left":
            d.array = -d.array
        d.camera_side = camera_side
        return d

    def as_depth(self, baseline: Optional[float] = None,
                 camera_intrinsic=None, focal_length: Optional[float] = None):
        """Depth = baseline * focal / |disparity| (infinite where the
        disparity is 0). The focal length is ``focal_length``, else fx of
        each item's intrinsic (its first matrix where the intrinsic's
        leading dims do not match the payload's)."""
        from .depth import Depth
        baseline = baseline if baseline is not None else self.baseline
        if baseline is None:
            raise ValueError("baseline required for disparity->depth")
        intrinsic = camera_intrinsic if camera_intrinsic is not None \
            else self.get_child("cam_intrinsic")
        if isinstance(intrinsic, dict):
            intrinsic = None
        disp = self.array.abs()
        if focal_length is None:
            if intrinsic is None:
                raise ValueError("camera intrinsic or focal_length required")
            focal_length = self._per_item(
                per_item(intrinsic, self._item_dims()[0])[..., 0, 0])
        depth = torch.where(disp > 0,
                            baseline * focal_length / disp.clamp(min=1e-9),
                            torch.full_like(disp, float("inf")))
        out = Depth(depth.float(), names=self._names)
        if intrinsic is not None:
            out.append_cam_intrinsic(intrinsic.clone())
        return out
