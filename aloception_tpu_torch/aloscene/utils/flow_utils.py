"""Optical-flow colour wheel (counterpart of
``aloception_tpu/aloscene/utils/flow_utils.py``: the Baker et al. wheel),
computed on the flow's device with the JAX package's numpy precisions:
float32 magnitudes and angles, float64 colour interpolation."""

from __future__ import annotations

import numpy as np
import torch


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: torch.Tensor, clip_flow=None, convert_to_bgr=False,
                  magnitude_max=None) -> torch.Tensor:
    """(H, W, 2) float32 flow -> (H, W, 3) float32 colours in 0..255."""
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {tuple(flow.shape)}")
    if clip_flow is not None:
        flow = flow.clamp(0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = torch.sqrt(u ** 2 + v ** 2)
    rad_max = magnitude_max if magnitude_max is not None else rad.max()
    # divisors as float32 tensors on the flow's device: true division, as
    # numpy's (CUDA multiplies by the reciprocal of a Python scalar)
    scale = torch.as_tensor(rad_max + 1e-5, dtype=torch.float32,
                            device=flow.device)
    pi = torch.tensor(np.pi, dtype=torch.float32, device=flow.device)
    u = u / scale
    v = v / scale
    rad = torch.sqrt(u ** 2 + v ** 2).double()

    wheel = torch.from_numpy(_WHEEL).to(flow.device, non_blocking=True)
    ncols = wheel.shape[0]
    # float32 angle, correctly rounded from float64 as numpy's arctan2
    a = torch.atan2(-v.double(), -u.double()).float() / pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = torch.floor(fk).long()
    k1 = (k0 + 1) % ncols
    f = (fk.double() - k0.double())[..., None]
    col = (1 - f) * (wheel[k0] / 255) + f * (wheel[k1] / 255)
    inside = (rad <= 1)[..., None]
    col = torch.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = torch.floor(255 * col).float()
    return img.flip(-1) if convert_to_bgr else img
