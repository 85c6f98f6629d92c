"""Points3D: (N, 3) camera-coordinate points (counterpart of
``aloception_tpu/aloscene/points_3d.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from .augmented import AugmentedArray
from .camera_calib import per_item
from .labels import Labels


class Points3D(AugmentedArray):

    def __init__(self, x, labels: Union[dict, Labels, None] = None,
                 names=("N", None), **kwargs):
        super().__init__(x, names=names, **kwargs)
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    def as_depth(self, camera_intrinsic, frame_size):
        """Planar depth map (1, H, W) on the points' device: each point with
        Z > 1e-9 lands at its projected pixel (rounded half to even and
        clamped to the frame) with value Z; where several land on one
        pixel, the last one wins. Uses the intrinsic's first matrix."""
        from .depth import Depth
        H, W = frame_size
        K = per_item(camera_intrinsic, ())
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        pts = self.array.reshape(-1, 3)
        z = pts[:, 2]
        valid = z > 1e-9
        zs = torch.where(valid, z, torch.ones_like(z))
        u = torch.round(pts[:, 0] / zs * fx + cx).long().clamp(0, W - 1)
        v = torch.round(pts[:, 1] / zs * fy + cy).long().clamp(0, H - 1)
        # the last point of each pixel, found deterministically; invalid
        # points go to a scratch slot past the frame
        flat = torch.where(valid, v * W + u, torch.full_like(u, H * W))
        last = torch.full((H * W + 1,), -1, dtype=torch.long,
                          device=self.device).scatter_reduce_(
            0, flat, torch.arange(len(z), device=self.device), "amax")[:H * W]
        z0 = torch.cat([z.float(), z.new_zeros(1, dtype=torch.float32)])
        depth = z0[torch.where(last >= 0, last, len(z))]
        out = Depth(depth.reshape(1, H, W), is_absolute=True, is_planar=True)
        out.append_cam_intrinsic(camera_intrinsic.clone())
        return out

    # 3D points are invariant under 2D image geometry (the projection
    # changes through the intrinsic, which transforms separately)
    def _hflip(self, **kw): return self.clone()
    def _vflip(self, **kw): return self.clone()
    def _resize(self, size01, **kw): return self.clone()
    def _crop(self, H_crop, W_crop, **kw): return self.clone()
    def _pad(self, oy, ox, **kw): return self.clone()
    def _rotate(self, angle, center=None, **kw): return self.clone()
    def _spatial_shift(self, sy, sx, **kw): return self.clone()
