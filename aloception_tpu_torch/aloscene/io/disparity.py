"""Disparity files: ``.pfm`` and KITTI's 16-bit ``.png`` (counterpart of
``aloception_tpu/aloscene/io/disparity.py``). A PNG is decoded by the port's
native loader at its stored depth; its values / 256 are pixels."""

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
    """(C, H, W) float32 disparity from a .pfm file, or from a grey PNG
    (uint16 / 256, KITTI's convention), negated if ``png_negate``, which a
    PNG needs set explicitly."""
    if path.endswith(".pfm"):
        return load_pfm(path)
    if path.endswith(".png"):
        from ...runtime import decode
        disp = decode(path, "anydepth").float()[..., 0] / 256.0
        if png_negate is None:
            raise ValueError(
                "png_negate must be set explicitly when loading .png disparity")
        if png_negate:
            disp = -disp
        return disp[None]
    raise InvalidSampleError(f"unsupported disparity format: {path}")
