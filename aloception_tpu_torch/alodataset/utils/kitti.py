"""KITTI calibration files (counterpart of
``aloception_tpu/alodataset/utils/kitti.py``, the port's own copy): parsed
on the host into float32 numpy arrays."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def load_calib_cam_to_cam(path: str) -> Dict[str, np.ndarray]:
    """``key: v0 v1 ...`` lines -> {key: float32 array}; a line without a
    colon or with a value that is not a number is skipped."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(v) for v in vals.split()], np.float32)
            except ValueError:
                continue
    return out


def intrinsic_from_calib(calib: Dict[str, np.ndarray], cam: int = 2
                         ) -> np.ndarray:
    """The 3x4 float32 projection matrix of camera ``cam``: ``P_rect_0X``
    (calib_cam_to_cam files), else ``PX`` (the object benchmark's);
    KeyError without either."""
    P = calib.get(f"P_rect_0{cam}", calib.get(f"P{cam}"))
    if P is None:
        raise KeyError(f"no projection matrix for cam {cam}")
    return P.reshape(3, 4).astype(np.float32)


def baseline_from_calib(calib: Dict[str, np.ndarray]) -> Optional[float]:
    """Stereo baseline (P2[0, 3] - P3[0, 3]) / P2[0, 0] from ``P_rect_02``
    and ``P_rect_03``, in float32 as the file's values are; None without
    either."""
    try:
        P2 = calib["P_rect_02"].reshape(3, 4)
        P3 = calib["P_rect_03"].reshape(3, 4)
        return float((P2[0, 3] - P3[0, 3]) / P2[0, 0])
    except KeyError:
        return None
