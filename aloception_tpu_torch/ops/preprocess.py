"""Device preprocessing (counterpart of ``aloception_tpu/ops/preprocess.py``):
``fused_preprocess`` takes a uint8 or float NHWC batch -> /255 -> optional
bilinear resize -> with ``train``, per-sample random horizontal flip and
brightness/contrast jitter -> norm_resnet; ``device_pipeline`` feeds it from
a loader of file paths through the native loader, a pinned host batch and an
asynchronous copy to the card.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..aloscene.io.errors import InvalidSampleError

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)


def draw_jitter(batch: int, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The train branch's per-sample draws on the generator's device: flip
    (bool, p = 0.5), brightness and contrast (uniform in [0.9, 1.1))."""
    dev = generator.device if generator is not None else "cpu"
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    bright = 0.9 + 0.2 * torch.rand(batch, generator=generator, device=dev)
    contrast = 0.9 + 0.2 * torch.rand(batch, generator=generator, device=dev)
    return flip, bright, contrast


def jitter(x: torch.Tensor, flip: torch.Tensor, bright: torch.Tensor,
           contrast: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1]: flip along W where ``flip``, then
    clip((x - mean) * contrast + mean * bright, 0, 1) with each image's
    mean (the JAX train branch's formula)."""
    shape = (-1, 1, 1, 1)
    flip, bright, contrast = (v.to(x.device).reshape(shape)
                              for v in (flip, bright, contrast))
    x = torch.where(flip, x.flip(2), x)
    mean_px = x.mean((1, 2, 3), keepdim=True)
    return torch.clamp((x - mean_px) * contrast + mean_px * bright, 0.0, 1.0)


def fused_preprocess(images: torch.Tensor,
                     out_size: Optional[Tuple[int, int]] = None,
                     dtype: torch.dtype = torch.bfloat16, *,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: (B, H, W, 3) uint8 or float on any device. Returns (images
    (B, H', W', 3) in ``dtype``, mask (B, H', W') of zeros).

    The resize is antialiased when it shrinks, as ``jax.image.resize``
    "bilinear" is. ``train`` jitters each image with draws from
    ``generator`` (see ``draw_jitter``)."""
    x = images.float() / 255.0
    if out_size is not None and tuple(out_size) != tuple(x.shape[1:3]):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    B, H, W, _ = x.shape
    if train:
        x = jitter(x, *draw_jitter(B, generator))
    # non_blocking: a blocking host-to-device copy would drain the stream
    mean = torch.tensor(RESNET_MEAN).to(x.device, non_blocking=True)
    std = torch.tensor(RESNET_STD).to(x.device, non_blocking=True)
    x = (x - mean) / std
    mask = torch.zeros((B, H, W), dtype=torch.float32, device=x.device)
    return x.to(dtype).contiguous(), mask


def device_pipeline(loader: Iterable, native_loader=None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = True,
                    out_size: Optional[Tuple[int, int]] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Host batches -> preprocessed (images, mask) on ``device``.

    ``loader`` yields lists of file paths, decoded by ``native_loader``
    (``runtime.NativeImageLoader`` in "raw" mode: 0-255 floats, which
    ``fused_preprocess`` divides by 255), or NHWC uint8/float batches. A
    host batch is copied to pinned memory, then to the card without
    blocking. A file that does not decode raises ``InvalidSampleError``
    naming it. With ``train`` the loader is walked again without end, each
    batch jittered; without, once."""
    if device is None:
        device = torch.device("cuda")
    while True:
        for batch in loader:
            if native_loader is not None and isinstance(batch[0], str):
                raw, ok = native_loader.load_batch(batch)
                if not bool(ok.all()):
                    bad = [p for p, good in zip(batch, ok.tolist())
                           if not good]
                    raise InvalidSampleError(f"native decode failed: {bad}")
            else:
                raw = torch.as_tensor(batch)
            if device.type == "cuda" and not raw.is_pinned():
                raw = raw.pin_memory()
            yield fused_preprocess(raw.to(device, non_blocking=True),
                                   out_size=out_size, dtype=dtype,
                                   train=train, generator=generator)
        if not train:
            return
