"""RAFT utilities (counterpart of ``aloception_tpu/models/raft/utils.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


class Padder:
    """Zero-pad (..., H, W) inputs to the next multiple of ``mult`` and crop
    outputs back. ``sintel`` centres the padding on both axes; any other mode
    centres it on W and puts all of it on top."""

    def __init__(self, shape: Sequence[int], mult: int = 8,
                 mode: str = "sintel"):
        H, W = shape[-2], shape[-1]
        pad_h, pad_w = (-H) % mult, (-W) % mult
        top = pad_h // 2 if mode == "sintel" else pad_h
        # (left, right, top, bottom), as F.pad takes them
        self._pad = (pad_w // 2, pad_w - pad_w // 2, top, pad_h - top)

    def pad(self, *inputs: torch.Tensor):
        outs = [F.pad(x, self._pad) for x in inputs]
        return outs if len(outs) > 1 else outs[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        left, right, top, bottom = self._pad
        H, W = x.shape[-2], x.shape[-1]
        return x[..., top:H - bottom, left:W - right]
