"""Device preprocessing, eval path (counterpart of
``aloception_tpu/ops/preprocess.py::fused_preprocess`` with ``train=False``):
uint8 or float NHWC batch -> /255 -> optional bilinear resize -> norm_resnet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)


def fused_preprocess(images: torch.Tensor,
                     out_size: Optional[Tuple[int, int]] = None,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: (B, H, W, 3) uint8 or float on any device. Returns (images
    (B, H', W', 3) in ``dtype``, mask (B, H', W') of zeros).

    The resize is antialiased when it shrinks, as ``jax.image.resize``
    "bilinear" is."""
    x = images.float() / 255.0
    if out_size is not None and tuple(out_size) != tuple(x.shape[1:3]):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    B, H, W, _ = x.shape
    # non_blocking: a blocking host-to-device copy would drain the stream
    mean = torch.tensor(RESNET_MEAN).to(x.device, non_blocking=True)
    std = torch.tensor(RESNET_STD).to(x.device, non_blocking=True)
    x = (x - mean) / std
    mask = torch.zeros((B, H, W), dtype=torch.float32, device=x.device)
    return x.to(dtype).contiguous(), mask
