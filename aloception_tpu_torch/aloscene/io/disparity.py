"""Disparity files: ``.pfm`` (counterpart of
``aloception_tpu/aloscene/io/disparity.py``). The ``.png`` branch waits for
the port's image decoder: it raises ``InvalidSampleError``."""

from __future__ import annotations

import re

import numpy as np
import torch

from .errors import InvalidSampleError


def load_pfm(path: str) -> torch.Tensor:
    """Read a PFM file -> (C, H, W) float32, rows top to bottom."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise InvalidSampleError(f"not a PFM file: {path}")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise InvalidSampleError(f"malformed PFM header: {path}")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    data = np.flipud(data.reshape(h, w, channels))  # stored bottom to top
    return torch.from_numpy(
        np.ascontiguousarray(data.transpose(2, 0, 1)).astype(np.float32))


def load_disp(path: str, png_negate=None) -> torch.Tensor:
    """(C, H, W) float32 disparity from a .pfm file."""
    if path.endswith(".pfm"):
        return load_pfm(path)
    if path.endswith(".png"):
        raise InvalidSampleError(
            f"cannot read {path}: .png disparity needs an image decoder, "
            "which the port does not have yet (the native loader, ROADMAP "
            "A10)")
    raise InvalidSampleError(f"unsupported disparity format: {path}")
