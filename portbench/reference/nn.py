"""Plain float32 building blocks of the reference detectors, and the
precisions the comparison's control computes in.

Every convolution and matrix product of the reference goes through a
``Precision``: ``float32`` leaves its operands as they are (TF32 off, see
``float32_matmuls``); ``tf32`` computes them in TF32 (on a card by the
library's TF32 path, elsewhere by rounding both operands to TF32's 10-bit
mantissa, the gradient passing straight through); ``fp8`` rounds both
operands to float8 e4m3 with a scale per tensor (amax / 448), as an fp8
matrix unit would take them, and accumulates in float32. Nothing here
imports the program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32).view(x.shape)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Precision:
    """What a matrix product's operands are rounded to (see the module)."""

    KINDS = ("float32", "tf32", "fp8")

    def __init__(self, kind: str = "float32", device=None):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r}: one of {self.KINDS}")
        self.kind = kind
        self.native_tf32 = kind == "tf32" and device is not None \
            and torch.device(device).type == "cuda"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return fake_fp8(x)
        if self.kind == "tf32" and not self.native_tf32:
            return x + (round_tf32(x.detach()) - x).detach()
        return x

    @contextlib.contextmanager
    def matmuls(self):
        """TF32 on in the libraries for a native ``tf32``, off otherwise."""
        with float32_matmuls(allow_tf32=self.native_tf32):
            yield


@contextlib.contextmanager
def float32_matmuls(allow_tf32: bool = False):
    """cuBLAS and cuDNN with TF32 as asked, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def linear(x, p, name, P):
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias")
    return F.linear(P.q(x), P.q(w), b)


def conv2d(x, p, name, P, stride=1, padding=0, bias=False):
    return F.conv2d(P.q(x), P.q(p[f"{name}.weight"]),
                    p[f"{name}.bias"] if bias else None,
                    stride=stride, padding=padding)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def group_norm(x, p, name, groups, eps):
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"],
                        eps)


def frozen_bn(x, p, name, eps):
    """BatchNorm with fixed statistics, NCHW."""
    w = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + eps)
    b = p[f"{name}.bias"] - p[f"{name}.running_mean"] * w
    return x * w[:, None, None] + b[:, None, None]


def mlp(x, p, name, n_layers, P):
    for j in range(n_layers):
        x = linear(x, p, f"{name}.layers.{j}", P)
        if j < n_layers - 1:
            x = F.relu(x)
    return x


def attention(q_in, k_in, v_in, p, name, n_heads, P, key_padding=None):
    """Multi-head attention with one packed input projection
    (``in_proj_weight``, ``in_proj_bias``) and ``out_proj``, as published
    DETR's ``nn.MultiheadAttention``: softmax(q k^T / sqrt(d)) v per head,
    padded keys (``key_padding`` True) left out."""
    w = p[f"{name}.in_proj_weight"]
    b = p[f"{name}.in_proj_bias"]
    C = q_in.shape[-1]
    q = F.linear(P.q(q_in), P.q(w[:C]), b[:C])
    k = F.linear(P.q(k_in), P.q(w[C:2 * C]), b[C:2 * C])
    v = F.linear(P.q(v_in), P.q(w[2 * C:]), b[2 * C:])
    B, Lq, _ = q.shape
    Lk = k.shape[1]
    d = C // n_heads
    q = q.view(B, Lq, n_heads, d).transpose(1, 2)
    k = k.view(B, Lk, n_heads, d).transpose(1, 2)
    v = v.view(B, Lk, n_heads, d).transpose(1, 2)
    s = torch.matmul(P.q(q), P.q(k).transpose(-1, -2)) / math.sqrt(d)
    if key_padding is not None:
        s = s.masked_fill(key_padding[:, None, None, :], float("-inf"))
    a = s.softmax(-1)
    o = torch.matmul(P.q(a), P.q(v)).transpose(1, 2).reshape(B, Lq, C)
    return linear(o, p, f"{name}.out_proj", P)


def sine_positions(mask, num_pos_feats, center, eps=1e-6,
                   temperature=10000.0):
    """Published DETR's sine embedding with ``normalize=True`` (scale 2 pi)
    from the padding mask (B, H, W), 1 = padded; ``center`` subtracts 0.5
    from the cumulative sums, as Deformable-DETR does. (B, H, W, 2F)."""
    not_mask = 1.0 - mask.float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    if center:
        y, x = y - 0.5, x - 0.5
    y = y / (y[:, -1:, :] + eps) * 2 * math.pi
    x = x / (x[:, :, -1:] + eps) * 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     -1).flatten(-2)
    return torch.cat([py, px], -1)


def resize_mask(mask, size, mode):
    """A (B, H, W) padding mask at a feature map's (h, w)."""
    return F.interpolate(mask.float()[:, None], size=tuple(size),
                         mode=mode)[:, 0]
