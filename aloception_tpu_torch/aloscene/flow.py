"""Flow and SceneFlow maps (counterpart of ``aloception_tpu/aloscene/
flow.py``; ``utils/flow_utils.py::flow_to_color`` holds its view's
colours)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .augmented import const
from .camera_calib import per_item
from .mask import Mask
from .spatial import SpatialAugmentedArray


class Flow(SpatialAugmentedArray):
    """Optical flow in pixels, channel 0 along x and 1 along y, with an
    optional occlusion ``Mask``. Under geometry the values follow the
    pixels: resize scales x and y by the size ratios, hflip negates x and
    vflip negates y."""

    def __init__(self, x, occlusion: Optional[Mask] = None,
                 names=("C", "H", "W"), **kwargs):
        if isinstance(x, str):
            from .io.flow import load_flow
            x = load_flow(x)
            names = ("C", "H", "W")
        super().__init__(x, names=names, **kwargs)
        self.add_child("occlusion", occlusion, align_dim=["B", "T"],
                       mergeable=True)

    def append_occlusion(self, occlusion: Mask, name: Optional[str] = None):
        self._append_child("occlusion", occlusion, name)

    def __get_view__(self, title=None, clip_flow=None, magnitude_max=None,
                     **kwargs):
        """The flow-wheel colours of the first item (flow.py:46), computed
        on the host."""
        from .renderer import View
        from .utils.flow_utils import flow_to_color
        arr = self.cpu().as_numpy()
        while arr.ndim > 3:
            arr = arr[0]
        f = np.moveaxis(arr, self.dim_idx("C") if arr.ndim == 3 else 0, -1)
        rgb = flow_to_color(torch.from_numpy(np.ascontiguousarray(
            f[..., :2])), clip_flow, magnitude_max=magnitude_max)
        return View((rgb / 255.0).numpy(), title=title)

    def _scale_components(self, out: "Flow", sx: float, sy: float) -> "Flow":
        """``out`` with its x values times ``sx`` and y values times ``sy``,
        in float32 and cast back to its dtype."""
        scale = [1.0] * out.size("C")
        scale[:2] = sx, sy
        shape = [1] * out.ndim
        shape[out.dim_idx("C")] = len(scale)
        arr = out.array.float() * const(scale, out.array).reshape(shape)
        return out._with_array(arr.to(out.dtype))

    def _resize(self, size01, **kwargs):
        H0, W0 = self.H, self.W
        out = super()._resize(size01, **kwargs)
        return self._scale_components(out, out.W / W0, out.H / H0)

    def _hflip(self, **kwargs):
        return self._scale_components(super()._hflip(**kwargs), -1.0, 1.0)

    def _vflip(self, **kwargs):
        return self._scale_components(super()._vflip(**kwargs), 1.0, -1.0)


class SceneFlow(SpatialAugmentedArray):
    """3-channel 3D scene flow (C, H, W), with an optional occlusion Mask."""

    def __init__(self, x, occlusion: Optional[Mask] = None,
                 names=("C", "H", "W"), **kwargs):
        super().__init__(x, names=names, **kwargs)
        self.add_child("occlusion", occlusion, align_dim=["B", "T"],
                       mergeable=True)

    def append_occlusion(self, occlusion: Mask, name: Optional[str] = None):
        self._append_child("occlusion", occlusion, name)

    @staticmethod
    def from_optical_flow(flow: Flow, depth1, depth2, intrinsic):
        """Lift a (2, H, W) optical flow to scene flow with the planar
        depths of both frames: P2(x + flow, Z2) - P1(x, Z1), on the flow's
        device. Uses the pinhole part of the intrinsic's first matrix (the
        JAX package reshapes the whole matrix to 3x3 and so fails on a
        CameraIntrinsic)."""
        f = flow.array
        if f.shape[0] != 2:
            raise ValueError(f"flow must be (2, H, W), got {tuple(f.shape)}")
        H, W = f.shape[1:]
        pts1 = depth1.as_points3d(intrinsic).array.reshape(H, W, 3)
        xs = torch.arange(W, dtype=torch.float32, device=f.device)[None, :]
        ys = torch.arange(H, dtype=torch.float32, device=f.device)[:, None]
        z2 = depth2.array.reshape(H, W)
        K = per_item(intrinsic, ())
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        pts2 = torch.stack([(xs + f[0] - cx) / fx * z2,
                            (ys + f[1] - cy) / fy * z2, z2], -1)
        out = SceneFlow((pts2 - pts1).permute(2, 0, 1).float(),
                        names=("C", "H", "W"))
        occ = flow.get_child("occlusion")
        if occ is not None and not isinstance(occ, dict):
            out.append_occlusion(occ.clone())
        return out
