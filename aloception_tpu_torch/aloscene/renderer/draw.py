"""Drawing primitives of the views, on (H, W, C) uint8 numpy images on the
host, equal bit for bit to the OpenCV 5 calls the JAX views make:

- ``rectangle``: ``cv2.rectangle(img, p1, p2, color, thickness)``;
- ``line``: ``cv2.line(img, p1, p2, color, thickness)``, clipped first to
  the image grown by the thickness, as cv2 does (an end far outside, as a
  3-D box's corner behind the camera, draws the same pixels).

Both are LINE_8 with a thickness of 2 or more (the views draw at 2): a
convex quadrilateral in 16.16 fixed point and filled circles at the capped
ends, computed by ``runtime/aloloader.cpp``. Points are integers in the
int32 range, as cv2 takes them; colours round and saturate to 0..255.
"""

from __future__ import annotations

import numpy as np

from ...runtime.loader import load_library

INT32 = (-2 ** 31, 2 ** 31 - 1)


def _draw(fn, img: np.ndarray, p1, p2, color, thickness: int) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or \
            not img.flags["C_CONTIGUOUS"]:
        raise ValueError("drawing needs a C-contiguous (H, W, C) uint8 image")
    if thickness < 2:
        raise ValueError("only thick lines (thickness >= 2) are drawn")
    pts = [int(v) for v in (*p1, *p2)]
    if any(not INT32[0] <= v <= INT32[1] for v in pts):
        raise ValueError(f"the points {pts} leave the int32 range, which "
                         "cv2 refuses too")
    col = np.zeros(img.shape[2], np.uint8)
    vals = np.clip(np.rint(np.asarray(color, np.float64)[:img.shape[2]]),
                   0, 255)
    col[:len(vals)] = vals
    fn(img.ctypes.data, img.shape[0], img.shape[1], img.shape[2], *pts,
       col.ctypes.data, thickness)
    return img


def line(img: np.ndarray, p1, p2, color, thickness: int = 2) -> np.ndarray:
    """``cv2.line`` in place; returns ``img``."""
    return _draw(load_library().alo_line, img, p1, p2, color, thickness)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 2
              ) -> np.ndarray:
    """``cv2.rectangle`` in place; returns ``img``."""
    return _draw(load_library().alo_rectangle, img, p1, p2, color, thickness)
