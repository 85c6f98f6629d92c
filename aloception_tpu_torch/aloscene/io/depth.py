"""Depth files: ``.npy`` / ``.npz`` (counterpart of
``aloception_tpu/aloscene/io/depth.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidSampleError


def load_depth(path: str, key: str = "arr_0") -> torch.Tensor:
    """(C, H, W) float32 depth; a 2-D array gains C = 1."""
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        arr = np.load(path)[key]
    else:
        raise InvalidSampleError(f"unsupported depth format: {path}")
    arr = arr.astype(np.float32)
    return torch.from_numpy(arr[None] if arr.ndim == 2 else arr)
