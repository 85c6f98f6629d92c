"""Multi-scale deformable attention in plain PyTorch: published
Deformable-DETR's ``ms_deform_attn_core_pytorch`` (one ``grid_sample`` per
level, bilinear, zero padding, align_corners False) and its ``MSDeformAttn``
module around it. The frozen operation count of one call is in
``counting.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import linear


def core(value, shapes, loc, weights):
    """value (B, Lv, nH, C); shapes [(H_l, W_l)]; loc (B, Lq, nH, L, P, 2)
    in [0, 1] as (x, y); weights (B, Lq, nH, L, P) -> (B, Lq, nH * C)."""
    B, _, nH, C = value.shape
    _, Lq, _, L, P, _ = loc.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * nH, C, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    a = weights.transpose(1, 2).reshape(B * nH, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * a).sum(-1)
    return out.view(B, nH * C, Lq).transpose(1, 2).contiguous()


def sampling(query, reference_points, shapes, p, name, cfg, P):
    """The module's sampling locations (B, Lq, nH, L, P, 2) and attention
    weights (B, Lq, nH, L, P) for ``query``: offsets in pixels of each level
    around 2-d reference points, or scaled by half the box around 4-d ones;
    weights softmaxed over levels x points."""
    B, Lq, _ = query.shape
    nH, L, Pn = cfg["nheads"], cfg["num_feature_levels"], cfg["n_points"]
    off = linear(query, p, f"{name}.sampling_offsets", P).view(
        B, Lq, nH, L, Pn, 2)
    w = linear(query, p, f"{name}.attention_weights", P).view(
        B, Lq, nH, L * Pn).softmax(-1).view(B, Lq, nH, L, Pn)
    if reference_points.shape[-1] == 2:
        norm = torch.tensor([[wd, h] for h, wd in shapes],
                            dtype=torch.float32, device=query.device)
        loc = reference_points[:, :, None, :, None, :] \
            + off / norm[None, None, None, :, None, :]
    else:
        loc = reference_points[:, :, None, :, None, :2] \
            + off / Pn * reference_points[:, :, None, :, None, 2:] * 0.5
    return loc, w


def module(query, reference_points, input_flatten, shapes, padding_mask,
           p, name, cfg, P):
    """Published ``MSDeformAttn.forward``."""
    B, Lv, _ = input_flatten.shape
    nH = cfg["nheads"]
    value = linear(input_flatten, p, f"{name}.value_proj", P)
    if padding_mask is not None:
        value = value.masked_fill(padding_mask[..., None], 0.0)
    value = value.view(B, Lv, nH, -1)
    loc, w = sampling(query, reference_points, shapes, p, name, cfg, P)
    out = core(P.q(value), shapes, loc, w)
    return linear(out, p, f"{name}.output_proj", P)
