"""Bilinear sampling and warping (counterpart of
``aloception_tpu/ops/warp.py``), channels first.

Pixel coordinates (x, y) index columns and rows; samples outside the image
are zero.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (C, H, W) at float pixel coordinates ``x``, ``y`` (any
    shape, the same for both) -> (C, *x.shape). Each of the four corners
    outside the image adds zero."""
    C, H, W = img.shape
    flat = img.reshape(C, H * W)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        idx = yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()
        return flat[:, idx.reshape(-1)].reshape(C, *x.shape) * valid

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))
            + gather(y0, x0 + 1) * ((1 - wy) * wx)
            + gather(y0 + 1, x0) * (wy * (1 - wx))
            + gather(y0 + 1, x0 + 1) * (wy * wx))


def coords_grid(H: int, W: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """(2, H, W) pixel coordinate grid, channels (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys])


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``img`` (C, H, W) by ``flow`` (2, H, W):
    out(p) = img(p + flow(p))."""
    _, H, W = img.shape
    grid = coords_grid(H, W, img.dtype, img.device) + flow
    return bilinear_sample(img, grid[0], grid[1])
