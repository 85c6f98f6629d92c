"""Camera calibration types (counterpart of
``aloception_tpu/aloscene/camera_calib.py``).

CameraIntrinsic: [..., 3|4, 4] pinhole projection matrix whose principal
point and focals follow flip/resize/crop/pad. CameraExtrinsic: [..., 4, 4]
world->camera transform, invariant under 2D image geometry. Updates run on
the matrix's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .augmented import AugmentedArray, as_tensor


class CameraIntrinsic(AugmentedArray):
    """Built from a matrix ``x``, or from ``focal_length`` (one value, or
    (fy, fx)), ``principal_point`` (y, x; default the centre of
    ``plane_size`` (H, W), else (0, 0)) and ``skew`` as a 4x4 matrix. A
    missing focal length is infinite."""

    def __init__(self, x=None, focal_length=None, plane_size=None,
                 principal_point=None, skew=None, names=(None, None),
                 **kwargs):
        if x is None:
            x = np.zeros((4, 4), dtype=np.float32)
            fl = focal_length if isinstance(focal_length, tuple) \
                else (focal_length, focal_length)
            x[0][0] = fl[1] if fl[1] is not None else np.inf
            x[1][1] = fl[0] if fl[0] is not None else np.inf
            x[0][1] = skew if skew is not None else 0
            if principal_point is None and plane_size is not None:
                principal_point = (plane_size[0] / 2, plane_size[1] / 2)
            elif principal_point is None:
                principal_point = (0, 0)
            x[0][2] = principal_point[1]
            x[1][2] = principal_point[0]
            x[2][2] = 1
            x[3][3] = 1
            names = (None, None)
        else:
            x = as_tensor(x.array if isinstance(x, AugmentedArray) else x)
            if x.shape[-1] != 4 or x.shape[-2] not in (3, 4):
                raise ValueError(f"an intrinsic matrix is [..., 3|4, 4], got "
                                 f"{tuple(x.shape)}")
            if names is None or len(names) != x.ndim:
                names = (None,) * x.ndim
        super().__init__(x, names=names, **kwargs)

    @property
    def focal_length(self) -> torch.Tensor:
        return self.array[..., [0, 1], [0, 1]]

    @property
    def principal_points(self) -> torch.Tensor:
        return self.array[..., [0, 1], [2, 2]]

    @property
    def skew(self) -> torch.Tensor:
        return self.array[..., 0, 1]

    def _updated(self, fn) -> "CameraIntrinsic":
        arr = self.array.clone()
        fn(arr)
        return self._with_array(arr)

    def _check_no_skew(self):
        """A flip mirrors the principal point only without skew (reads the
        skew back to the host: one sync on the card)."""
        if not bool((self.skew.abs() < 1e-3).all()):
            raise ValueError("cannot flip an intrinsic with skew")

    def _hflip(self, *args, frame_size: Tuple[int, int], **kwargs):
        self._check_no_skew()
        return self._updated(lambda a: a.__setitem__(
            (..., 0, 2), frame_size[1] - a[..., 0, 2]))

    def _vflip(self, *args, frame_size: Tuple[int, int], **kwargs):
        self._check_no_skew()
        return self._updated(lambda a: a.__setitem__(
            (..., 1, 2), frame_size[0] - a[..., 1, 2]))

    def _resize(self, size01, **kwargs):
        def fn(a):
            a[..., 0, 0] *= size01[1]
            a[..., 1, 1] *= size01[0]
            a[..., 0, 2] *= size01[1]
            a[..., 1, 2] *= size01[0]
        return self._updated(fn)

    def _crop(self, H_crop, W_crop, frame_size, **kwargs):
        def fn(a):
            a[..., 0, 2] -= W_crop[0] * frame_size[1]
            a[..., 1, 2] -= H_crop[0] * frame_size[0]
        return self._updated(fn)

    def _pad(self, offset_y, offset_x, frame_size, **kwargs):
        def fn(a):
            a[..., 0, 2] += offset_x[0] * frame_size[1]
            a[..., 1, 2] += offset_y[0] * frame_size[0]
        return self._updated(fn)

    def _rotate(self, angle, center=None, **kwargs):
        raise NotImplementedError("a rotation has no pinhole intrinsic")

    def _spatial_shift(self, sy, sx, **kwargs):
        raise NotImplementedError("a spatial shift has no pinhole intrinsic")


class CameraExtrinsic(AugmentedArray):
    """[..., 4, 4] camera pose; invariant under 2D image geometry."""

    def __init__(self, x, names=None, **kwargs):
        x = as_tensor(x.array if isinstance(x, AugmentedArray) else x)
        if x.shape[-2:] != (4, 4):
            raise ValueError(f"an extrinsic matrix is [..., 4, 4], got "
                             f"{tuple(x.shape)}")
        if names is None or len(names) != x.ndim:
            names = (None,) * x.ndim
        super().__init__(x, names=names, **kwargs)

    def translation_with(self, tgt_pos: "CameraExtrinsic") -> torch.Tensor:
        """Translation of the target pose expressed in this pose's frame."""
        t = torch.linalg.solve(self.array, tgt_pos.array)
        return t[..., :3, -1]

    def distance_with(self, tgt_pos: "CameraExtrinsic") -> torch.Tensor:
        return torch.linalg.vector_norm(self.translation_with(tgt_pos), dim=-1)

    def _hflip(self, *a, **kw): return self.clone()
    def _vflip(self, *a, **kw): return self.clone()
    def _resize(self, *a, **kw): return self.clone()
    def _crop(self, *a, **kw): return self.clone()
    def _pad(self, *a, **kw): return self.clone()
    def _rotate(self, *a, **kw): return self.clone()
    def _spatial_shift(self, *a, **kw): return self.clone()


class Pose(CameraExtrinsic):
    """A pose is an extrinsic-style 4x4 transform."""


def per_item(calib: AugmentedArray, lead: Tuple[int, ...]) -> torch.Tensor:
    """The calibration matrix of each item of a payload whose leading (B/T)
    dims are ``lead``: ``calib``'s matrices broadcast to (*lead, R, 4) when
    their leading dims broadcast to ``lead``, else its first matrix (R, 4),
    as the JAX package takes for every item."""
    K = calib.array
    k_lead = K.shape[:-2]
    if len(k_lead) <= len(lead) and all(
            k in (1, n) for k, n in zip(k_lead[::-1], lead[::-1])):
        return K.expand(tuple(lead) + K.shape[-2:])
    return K.reshape((-1,) + K.shape[-2:])[0]
