"""Optical-flow files: Middlebury ``.flo`` and ``.npy`` (counterpart of
``aloception_tpu/aloscene/io/flow.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidSampleError

_FLO_MAGIC = 202021.25


def load_flow_flo(path: str) -> torch.Tensor:
    """Read a .flo file -> (2, H, W) float32 (x-flow, y-flow)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise InvalidSampleError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise InvalidSampleError(f"truncated .flo file: {path}")
    return torch.from_numpy(data.reshape(h, w, 2).transpose(2, 0, 1).copy())


def save_flow_flo(path: str, flow):
    """Write a (2, H, W) flow (tensor on any device, or array) to .flo."""
    if isinstance(flow, torch.Tensor):
        flow = flow.detach().cpu().numpy()
    if flow.ndim != 3 or flow.shape[0] != 2:
        raise ValueError(f"flow must be (2, H, W), got {flow.shape}")
    h, w = flow.shape[1:]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.transpose(1, 2, 0).astype(np.float32).tofile(f)


def load_flow(path: str) -> torch.Tensor:
    """(2, H, W) float32 flow from a .flo or .npy file."""
    if path.endswith(".flo"):
        return load_flow_flo(path)
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        return torch.from_numpy(arr if arr.shape[0] == 2
                                else np.ascontiguousarray(
                                    arr.transpose(2, 0, 1)))
    raise InvalidSampleError(f"unsupported flow format: {path}")
