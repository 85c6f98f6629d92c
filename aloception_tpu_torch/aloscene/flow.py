"""Flow: optical flow maps (counterpart of ``aloception_tpu/aloscene/
flow.py``, without loading from files and views; ``SceneFlow`` waits for
depth and 3D points, ROADMAP A9)."""

from __future__ import annotations

from typing import Optional

from .augmented import const
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
            raise NotImplementedError(
                "Flow(path): loading flow files is not ported yet (ROADMAP "
                "A9); pass a tensor")
        super().__init__(x, names=names, **kwargs)
        self.add_child("occlusion", occlusion, align_dim=["B", "T"],
                       mergeable=True)

    def append_occlusion(self, occlusion: Mask, name: Optional[str] = None):
        self._append_child("occlusion", occlusion, name)

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
