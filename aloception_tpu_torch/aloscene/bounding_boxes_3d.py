"""BoundingBoxes3D: N x 7 camera-coordinate boxes [xc, yc, zc, Dx, Dy, Dz,
heading] (counterpart of ``aloception_tpu/aloscene/bounding_boxes_3d.py``).

Vertices, their image projection (through a ``CameraIntrinsic``), enclosing
2D boxes and the pairwise 3D IoU/GIoU through ``ops/rotated_iou.py``, all on
the boxes' device. The heading turns about the camera's Y axis, so the
bird's-eye plane is (x, z). There is no ``_rotate``: rotating a frame
carries its 3D boxes over unchanged, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops import rotated_iou as riou
from .augmented import AugmentedArray, const
from .bounding_boxes_2d import BoundingBoxes2D
from .camera_calib import per_item
from .labels import Labels

# vertex signs of the half-extents along x, y, z
_SIGNS = ((1, 1, 1, 1, -1, -1, -1, -1),
          (1, 1, -1, -1, 1, 1, -1, -1),
          (1, -1, 1, -1, 1, -1, 1, -1))


class BoundingBoxes3D(AugmentedArray):

    def __init__(self, x, labels: Union[dict, Labels, None] = None,
                 names=("N", None), **kwargs):
        super().__init__(x, names=names, **kwargs)
        if self.shape[-1] != 7:
            raise ValueError("boxes3d are [xc, yc, zc, Dx, Dy, Dz, heading], "
                             f"got {self.shape[-1]} columns")
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)
        self.add_child("cam_intrinsic", None, align_dim=["B", "T"],
                       mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    def append_cam_intrinsic(self, cam_intrinsic, name: Optional[str] = None):
        self._append_child("cam_intrinsic", cam_intrinsic, name)

    # ------------------------------------------------------------------
    def get_vertices_3d(self) -> torch.Tensor:
        """(N, 8, 3) corner vertices in camera coordinates (leading dims
        flattened into N)."""
        b = self.array.reshape(-1, 7)
        half = [b[:, None, 3 + i] * (0.5 * const(_SIGNS[i], b)) for i in
                range(3)]                                        # 3 x (N, 8)
        cos, sin = torch.cos(b[:, 6:7]), torch.sin(b[:, 6:7])
        x = cos * half[0] + sin * half[2]
        z = cos * half[2] - sin * half[0]
        return torch.stack([x, half[1], z], -1) + b[:, None, :3]

    def get_vertices_3d_proj(self, cam_intrinsic) -> torch.Tensor:
        """(N, 8, 2) vertices projected to image pixels. Each box takes the
        intrinsic of its item where the intrinsic's leading dims match the
        boxes' (B/T) dims, else the intrinsic's first matrix."""
        v = self.get_vertices_3d()
        K = per_item(cam_intrinsic, self.shape[:-2])
        n_per_item = self.shape[-2]
        fx, fy, cx, cy = (k.reshape(-1, 1).repeat_interleave(n_per_item, 0)
                          if k.ndim else k
                          for k in (K[..., 0, 0], K[..., 1, 1],
                                    K[..., 0, 2], K[..., 1, 2]))
        z = v[..., 2].clamp(min=1e-6)
        u = v[..., 0] / z * fx + cx
        w = v[..., 1] / z * fy + cy
        return torch.stack([u, w], -1)

    def get_enclosing_box_2d(self, cam_intrinsic, frame_size: Tuple[int, int]
                             ) -> BoundingBoxes2D:
        """Axis-aligned xyxy 2D box enclosing each projected box, absolute
        in ``frame_size``, with a copy of the labels."""
        proj = self.get_vertices_3d_proj(cam_intrinsic)
        boxes = torch.cat([proj.amin(-2), proj.amax(-2)], -1).float()
        out = BoundingBoxes2D(boxes, boxes_format="xyxy", absolute=True,
                              frame_size=frame_size)
        labels = self.get_child("labels")
        if labels is not None and not isinstance(labels, dict):
            out.append_labels(labels.clone())
        return out

    def bev_boxes(self) -> torch.Tensor:
        """(N, 5) bird's-eye-view rotated boxes [xc, zc, Dx, Dz, heading]."""
        b = self.array.reshape(-1, 7)
        return b[:, [0, 2, 3, 5, 6]]

    def iou3d_with(self, boxes2: "BoundingBoxes3D") -> torch.Tensor:
        """Pairwise 3D IoU (N, M)."""
        return riou.pairwise(riou.cal_iou_3d, _to_riou_layout(self),
                             _to_riou_layout(boxes2))

    def giou3d_with(self, boxes2: "BoundingBoxes3D") -> torch.Tensor:
        """Pairwise 3D GIoU (N, M)."""
        return riou.pairwise(riou.cal_giou_3d, _to_riou_layout(self),
                             _to_riou_layout(boxes2))[0]

    _EDGES = ((0, 1), (1, 3), (3, 2), (2, 0),      # front face
              (4, 5), (5, 7), (7, 6), (6, 4),      # back face
              (0, 4), (1, 5), (2, 6), (3, 7))      # connectors

    def _view_projection(self, intrinsic) -> np.ndarray:
        """(N, 8, 2) projected vertices for the view, in float64 on the
        host with the JAX view's arithmetic (float32 payload, float64
        rotation and projection), each item with its intrinsic
        (``per_item``)."""
        b = self.as_numpy().reshape(-1, 7)
        dx, dy, dz = b[:, 3], b[:, 4], b[:, 5]
        sx, sy, sz = (np.array(s) * 0.5 for s in _SIGNS)
        corners = np.stack([sx[None] * dx[:, None], sy[None] * dy[:, None],
                            sz[None] * dz[:, None]], axis=-1)
        cos, sin = np.cos(b[:, 6]), np.sin(b[:, 6])
        rot = np.zeros((len(b), 3, 3))
        rot[:, 0, 0] = cos
        rot[:, 0, 2] = sin
        rot[:, 1, 1] = 1
        rot[:, 2, 0] = -sin
        rot[:, 2, 2] = cos
        v = np.einsum("nij,nkj->nki", rot, corners) + b[:, None, :3]
        K = per_item(intrinsic, self.shape[:-2]).numpy()
        if K.ndim > 2:
            K = np.repeat(K.reshape((-1,) + K.shape[-2:]), self.shape[-2],
                          0)[:, None]
        fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], \
            K[..., 1, 2]
        z = np.maximum(v[..., 2], 1e-6)
        return np.stack([v[..., 0] / z * fx + cx, v[..., 1] / z * fy + cy],
                        axis=-1)

    def __get_view__(self, frame=None, cam_intrinsic=None, frame_size=None,
                     title=None, **kwargs):
        """Wireframes of the boxes projected onto ``frame`` (a float [0, 1]
        HWC image, or black of ``frame_size``, 300x300 without one),
        computed on the host (bounding_boxes_3d.py:472): the 12 edges of
        each box as 2-pixel lines in its label's colour (its index's
        without labels). None without an intrinsic (``cam_intrinsic`` or
        the boxes' own)."""
        from .renderer import View
        from .renderer.draw import line
        host = self.cpu()
        intrinsic = cam_intrinsic if cam_intrinsic is not None \
            else host.get_child("cam_intrinsic")
        if intrinsic is None or isinstance(intrinsic, dict):
            return None
        if frame is None:
            fs = frame_size or (300, 300)
            frame = np.zeros((int(fs[0]), int(fs[1]), 3), np.float32)
        img = (np.clip(np.ascontiguousarray(frame), 0, 1) * 255
               ).astype(np.uint8)
        proj = host._view_projection(intrinsic.cpu())
        colors = np.random.RandomState(11).uniform(0, 255, (300, 3))
        labels = host.get_child("labels")
        lab = labels.as_numpy().astype(int) \
            if labels is not None and not isinstance(labels, dict) else None
        for n in range(proj.shape[0]):
            color = tuple(int(c) for c in
                          colors[(lab[n] if lab is not None else n) % 300])
            for a, b in self._EDGES:
                line(img, tuple(int(v) for v in proj[n, a]),
                     tuple(int(v) for v in proj[n, b]), color, 2)
        return View(img.astype(np.float32) / 255.0, title=title)

    def get_view(self, frame=None, **kwargs):
        return self.__get_view__(frame=frame, **kwargs)

    def _hflip(self, cam_extrinsic=None, **kw):
        """Mirror across the camera's x axis. With ``cam_extrinsic``
        (vehicle -> camera 4x4; its first matrix, as the JAX package) the
        flip happens in the camera frame: centres go through E, x is
        negated, then back through inv(E); headings become
        -h - 2 * rot_y(E). Computed in float64, cast back."""
        arr = self.array
        if cam_extrinsic is None or isinstance(cam_extrinsic, dict):
            return self._with_array(
                arr * const([-1, 1, 1, 1, 1, 1, -1], arr))
        E = per_item(cam_extrinsic, ()).double()
        flat = arr.reshape(-1, 7).double()
        c = torch.cat([flat[:, :3], torch.ones_like(flat[:, :1])], -1) @ E.T
        c = c * torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=torch.float64,
                             device=c.device)
        c = c @ torch.linalg.inv(E).T
        R = E[:3, :3]
        rot_y = torch.atan2(-R[2, 0], torch.hypot(R[2, 1], R[2, 2]))
        out = torch.cat([c[:, :3], flat[:, 3:6], -flat[:, 6:7] - 2.0 * rot_y],
                        -1)
        return self._with_array(out.reshape(arr.shape).to(arr.dtype))

    def _vflip(self, **kw):
        return self._with_array(self.array
                                * const([1, -1, 1, 1, 1, 1, 1], self.array))

    # 3D boxes are invariant under image resize/crop/pad/shift
    def _resize(self, size01, **kw): return self.clone()
    def _crop(self, H_crop, W_crop, **kw): return self.clone()
    def _pad(self, oy, ox, **kw): return self.clone()
    def _spatial_shift(self, sy, sx, **kw): return self.clone()


def _to_riou_layout(boxes: BoundingBoxes3D) -> torch.Tensor:
    """[xc, yc, zc, Dx, Dy, Dz, heading] camera coordinates -> the
    rotated-IoU layout [x, z, y, Dx, Dz, Dy, heading]: the (x, z) plane is
    the ground plane, y the vertical, in float32."""
    return boxes.array.reshape(-1, 7)[:, [0, 2, 1, 3, 5, 4, 6]].float()
