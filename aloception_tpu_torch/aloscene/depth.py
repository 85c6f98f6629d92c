"""Depth maps with their scale state (counterpart of
``aloception_tpu/aloscene/depth.py``).

State: ``is_absolute`` (with the scale/shift of the inverse encoding) and
``is_planar`` (planar Z vs euclidean ray length). Conversions run on the
payload's device. The pinhole rays of a batched depth map come from each
item's own intrinsic where the intrinsic carries the same leading (B/T)
dims, else from its first matrix (the JAX package takes the first for
every item).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .camera_calib import per_item
from .mask import Mask
from .spatial import SpatialAugmentedArray


class Depth(SpatialAugmentedArray):

    def __init__(self, x, occlusion: Optional[Mask] = None,
                 is_absolute: bool = True, scale=None, shift=None,
                 is_planar: bool = True, projection: str = "pinhole",
                 names=("C", "H", "W"), **kwargs):
        if isinstance(x, str):
            from .io.depth import load_depth
            x = load_depth(x)
            names = ("C", "H", "W")
        super().__init__(x, names=names, **kwargs)
        self.add_child("occlusion", occlusion, align_dim=["B", "T"],
                       mergeable=True)
        self.add_property("scale", scale)
        self.add_property("shift", shift)
        self.add_property("is_absolute", is_absolute)
        self.add_property("is_planar", is_planar)
        self.add_property("projection", projection)

    def append_occlusion(self, occlusion: Mask, name: Optional[str] = None):
        self._append_child("occlusion", occlusion, name)

    def __get_view__(self, title=None, min_depth=None, max_depth=None,
                     cmap="nipy_spectral", reverse: bool = True, **kwargs):
        """The colour-mapped depth of the first item (depth.py:183), from
        ``min_depth`` (the least value) to ``max_depth`` (the largest),
        reversed by default; infinities count as 0. Computed on the
        host."""
        from .renderer import View
        from .renderer.colormap import apply_colormap
        arr = np.asarray(self.cpu().as_numpy(), np.float64)
        while arr.ndim > 2:
            arr = arr[0]
        arr = np.nan_to_num(arr, posinf=0, neginf=0)
        lo = min_depth if min_depth is not None else arr.min()
        hi = max_depth if max_depth is not None else max(arr.max(), lo + 1e-6)
        norm = np.clip((arr - lo) / (hi - lo), 0, 1)
        if reverse:
            norm = 1 - norm
        return View(apply_colormap(norm, cmap).astype(np.float32),
                    title=title)

    # ------------------------------------------------------------------
    def _with_state(self, array, **state) -> "Depth":
        n = self._with_array(array)
        for k, v in state.items():
            setattr(n, k, v)
        return n

    def encode_inverse(self, prior_clamp_min=None, prior_clamp_max=None,
                       post_clamp_min=None, post_clamp_max=None) -> "Depth":
        """Absolute depth -> scaled inverse depth (1 / d - shift) / scale."""
        if not self.is_absolute:
            return self.clone()
        shift = self.shift if self.shift is not None else 0
        scale = self.scale if self.scale is not None else 1
        arr = self.array
        if prior_clamp_min is not None or prior_clamp_max is not None:
            arr = arr.clamp(prior_clamp_min, prior_clamp_max)
        arr = (1.0 / arr - shift) / scale
        if post_clamp_min is not None or post_clamp_max is not None:
            arr = arr.clamp(post_clamp_min, post_clamp_max)
        return self._with_state(arr, scale=None, shift=None,
                                is_absolute=False)

    def encode_absolute(self, scale=1, shift=0, prior_clamp_min=None,
                        prior_clamp_max=None, post_clamp_min=None,
                        post_clamp_max=None, keep_negative: bool = False
                        ) -> "Depth":
        """Inverse depth -> absolute depth 1 / (scale * d + shift)."""
        if self.is_absolute:
            return self.clone()
        arr = self.array
        if prior_clamp_min is not None or prior_clamp_max is not None:
            arr = arr.clamp(prior_clamp_min, prior_clamp_max)
        arr = scale * arr + shift
        if not keep_negative:
            arr = arr.clamp(min=0)
        arr = 1.0 / arr
        if post_clamp_min is not None or post_clamp_max is not None:
            arr = arr.clamp(post_clamp_min, post_clamp_max)
        return self._with_state(arr, scale=scale, shift=shift,
                                is_absolute=True)

    # ------------------------------------------------------------------
    def _intrinsic_or_raise(self, camera_intrinsic):
        intrinsic = camera_intrinsic if camera_intrinsic is not None \
            else self.get_child("cam_intrinsic")
        if intrinsic is None or isinstance(intrinsic, dict):
            raise ValueError("camera_intrinsic required (attach one or pass "
                             "it)")
        return intrinsic

    def _pinhole_rays(self, intrinsic):
        """(dx, dy) = ((x - cx) / fx, (y - cy) / fy) of every pixel, shaped
        to broadcast over the payload (C = 1)."""
        K = per_item(intrinsic, self._item_dims()[0])
        fx, fy, cx, cy = (self._per_item(k) for k in (
            K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]))
        grid = [1] * self.ndim
        grid[self.dim_idx("W")] = self.W
        xs = torch.arange(self.W, dtype=torch.float32,
                          device=self.device).reshape(grid)
        grid[self.dim_idx("W")], grid[self.dim_idx("H")] = 1, self.H
        ys = torch.arange(self.H, dtype=torch.float32,
                          device=self.device).reshape(grid)
        return (xs - cx) / fx, (ys - cy) / fy

    def _ray_norm(self, intrinsic) -> torch.Tensor:
        dx, dy = self._pinhole_rays(intrinsic)
        return torch.sqrt(dx * dx + dy * dy + 1.0)

    def as_planar(self, camera_intrinsic=None, **kwargs) -> "Depth":
        """Euclidean (ray length) -> planar Z."""
        if self.is_planar:
            return self.clone()
        norm = self._ray_norm(self._intrinsic_or_raise(camera_intrinsic))
        return self._with_state(self.array / norm, is_planar=True)

    def as_euclidean(self, camera_intrinsic=None, **kwargs) -> "Depth":
        """Planar Z -> euclidean ray length."""
        if not self.is_planar:
            return self.clone()
        norm = self._ray_norm(self._intrinsic_or_raise(camera_intrinsic))
        return self._with_state(self.array * norm, is_planar=False)

    def as_points3d(self, camera_intrinsic=None):
        """Back-project every pixel to camera coordinates: Points3D of
        (lead..., H * W, 3), NaN and infinities set to 0."""
        from .points_3d import Points3D
        intrinsic = self._intrinsic_or_raise(camera_intrinsic)
        depth = self if self.is_planar else self.as_planar(intrinsic)
        lead, view = self._item_dims()
        hw = list(lead) + [self.H, self.W]
        view[self.dim_idx("H")], view[self.dim_idx("W")] = self.H, self.W
        dx, dy = (r.expand(view).reshape(hw)
                  for r in self._pinhole_rays(intrinsic))
        z = depth.array.reshape(hw)
        pts = torch.stack([dx * z, dy * z, z], -1)
        pts = torch.nan_to_num(pts.reshape(list(lead) + [self.H * self.W, 3]),
                               nan=0.0, posinf=0.0, neginf=0.0)
        names = tuple(n for n in self._names if n not in ("C", "H", "W")) \
            + ("N", None)
        return Points3D(pts.float(), names=names)

    def as_disp(self, camera_side: Optional[str] = None,
                baseline: Optional[float] = None, camera_intrinsic=None):
        """Depth -> unsigned disparity baseline * fx / depth (infinities
        and NaN set to 0), with a copy of the intrinsic."""
        from .disparity import Disparity
        baseline = baseline if baseline is not None else self.baseline
        camera_side = camera_side if camera_side is not None \
            else self.camera_side
        intrinsic = self._intrinsic_or_raise(camera_intrinsic)
        if baseline is None:
            raise ValueError("baseline required for depth->disparity")
        focal = self._per_item(
            per_item(intrinsic, self._item_dims()[0])[..., 0, 0])
        disp = torch.nan_to_num(baseline * focal / self.array,
                                nan=0.0, posinf=0.0, neginf=0.0)
        out = Disparity(disp.float(), disp_format="unsigned",
                        names=self._names, baseline=baseline,
                        camera_side=camera_side)
        out.append_cam_intrinsic(intrinsic.clone())
        return out
