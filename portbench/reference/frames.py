"""The serving cells' frame path in plain float32: uint8 CHW frames ->
[0, 1] -> ImageNet mean/std -> bilinear resize (half-pixel centres, no
antialiasing) to a longer side -> padded at the bottom and right to a fixed
size with black in the normalised space, with a mask of the padding."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)


def resized_hw(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """The frame's size once its longer side is ``long_side``."""
    scale = long_side / max(h, w)
    return round(h * scale), round(w * scale)


def prepare(frames: Sequence[torch.Tensor], long_side: int,
            pad_to: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(images (B, H, W, 3), mask (B, H, W), 1 = padded) on ``device``."""
    mean = torch.tensor(RESNET_MEAN, device=device)[:, None, None]
    std = torch.tensor(RESNET_STD, device=device)[:, None, None]
    H, W = pad_to
    images = ((0.0 - mean) / std).expand(len(frames), 3, H, W).clone()
    mask = torch.ones(len(frames), H, W, device=device)
    for i, f in enumerate(frames):
        x = (f.to(device).float() / 255.0 - mean) / std
        h, w = resized_hw(x.shape[1], x.shape[2], long_side)
        x = F.interpolate(x[None], size=(h, w), mode="bilinear",
                          align_corners=False, antialias=False)[0]
        images[i, :, :h, :w] = x
        mask[i, :h, :w] = 0.0
    return images.permute(0, 2, 3, 1).contiguous(), mask

