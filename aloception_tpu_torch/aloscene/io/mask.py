"""Mask files -> (1, H, W) float32 in [0, 1] (counterpart of
``aloception_tpu/aloscene/io/mask.py``): the image read as grey, / 255. An
unreadable file raises ``InvalidSampleError``."""

from __future__ import annotations

import torch


def load_mask(path: str) -> torch.Tensor:
    from ...runtime import decode
    return (decode(path, "gray").float() / 255.0).permute(2, 0, 1)
