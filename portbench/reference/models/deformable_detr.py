"""Deformable-DETR-R50 with iterative box refinement
(fundamentalvision/Deformable-DETR,
``configs/r50_deformable_detr_plus_iterative_bbox_refinement.sh``) in plain
float32: ResNet-50 C3-C5 and a stride-2 level on C5, each projected with
GroupNorm; a 6-layer deformable encoder over the 4 levels; 300 queries
through a 6-layer decoder of self-attention and deformable cross-attention
whose per-layer box heads move the reference points; sigmoid class heads.
Departures from the published code are the configuration's (``reduced``):
LayerNorm's epsilon, how the padding masks are resized, and the loss and
optimizer settings the port takes from aloception."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import backbone, msda
from ..nn import attention, conv2d, group_norm, layer_norm, linear, mlp, \
    resize_mask, sine_positions
from .detr import _attn_specs, _linear_specs, _norm_specs


def grid_bias(n_heads, n_levels, n_points) -> torch.Tensor:
    """Published ``MSDeformAttn._reset_parameters``' offset bias: head h
    points at angle 2 pi h / nH, the k-th point k + 1 pixels out."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for k in range(n_points):
        grid[:, :, k, :] *= k + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


def _msda_specs(name, cfg):
    d, nh = cfg["hidden_dim"], cfg["nheads"]
    lp = cfg["num_feature_levels"] * cfg["n_points"]
    return [(f"{name}.sampling_offsets.weight", (nh * lp * 2, d), "zeros"),
            (f"{name}.sampling_offsets.bias", (nh * lp * 2,),
             f"msda_grid:{nh},{cfg['num_feature_levels']},{cfg['n_points']}"),
            (f"{name}.attention_weights.weight", (nh * lp, d), "zeros"),
            (f"{name}.attention_weights.bias", (nh * lp,), "zeros")] \
        + _linear_specs(f"{name}.value_proj", d, d) \
        + _linear_specs(f"{name}.output_proj", d, d)


IN_CHANNELS = (512, 1024, 2048)


def param_specs(cfg) -> List:
    d, ff = cfg["hidden_dim"], cfg["dim_feedforward"]
    L = cfg["num_feature_levels"]
    specs = backbone.param_specs(cfg["stage_sizes"])
    for lvl in range(L):
        cin = IN_CHANNELS[min(lvl, 2)]
        k = 1 if lvl < 3 else 3
        specs += [(f"input_proj.{lvl}.0.weight", (d, cin, k, k), "lecun"),
                  (f"input_proj.{lvl}.0.bias", (d,), "zeros")]
        specs += _norm_specs(f"input_proj.{lvl}.1", d)
    specs += [("query_embed.weight", (cfg["num_queries"], 2 * d), "normal"),
              ("transformer.level_embed", (L, d), "normal")]
    specs += _linear_specs("transformer.reference_points", 2, d)
    for i in range(cfg["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        specs += _msda_specs(f"{n}.self_attn", cfg)
        specs += _norm_specs(f"{n}.norm1", d)
        specs += _linear_specs(f"{n}.linear1", ff, d)
        specs += _linear_specs(f"{n}.linear2", d, ff)
        specs += _norm_specs(f"{n}.norm2", d)
    for i in range(cfg["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        specs += _msda_specs(f"{n}.cross_attn", cfg)
        specs += _norm_specs(f"{n}.norm1", d)
        specs += _attn_specs(f"{n}.self_attn", d)
        specs += _norm_specs(f"{n}.norm2", d)
        specs += _linear_specs(f"{n}.linear1", ff, d)
        specs += _linear_specs(f"{n}.linear2", d, ff)
        specs += _norm_specs(f"{n}.norm3", d)
    for i in range(cfg["dec_layers"]):
        specs += _linear_specs(f"class_embed.{i}", cfg["num_classes"], d)
        for j, cout in enumerate((d, d, 4)):
            specs += _linear_specs(f"bbox_embed.{i}.layers.{j}", cout, d)
    return specs


def aliases(cfg) -> Dict[str, str]:
    """With refinement the decoder holds the model's box heads: the same
    tensors under a second name."""
    out = {}
    for name, _, _ in param_specs(cfg):
        if name.startswith("bbox_embed."):
            out[f"transformer.decoder.{name}"] = name
    return out


def inverse_sigmoid(x):
    x = x.clamp(1e-5, 1 - 1e-5)
    return torch.log(x / (1 - x))


def _valid_ratios(masks):
    out = []
    for m in masks:
        nm = 1.0 - m.float()
        vh, vw = nm[:, :, 0].sum(1), nm[:, 0, :].sum(1)
        out.append(torch.stack([vw / m.shape[2], vh / m.shape[1]], -1))
    return torch.stack(out, 1)                               # (B, L, 2)


def _encoder_reference(shapes, ratios):
    refs = []
    for lvl, (H, W) in enumerate(shapes):
        ys, xs = torch.meshgrid(
            torch.linspace(0.5, H - 0.5, H, device=ratios.device),
            torch.linspace(0.5, W - 0.5, W, device=ratios.device),
            indexing="ij")
        ry = ys.reshape(-1)[None] / (ratios[:, None, lvl, 1] * H)
        rx = xs.reshape(-1)[None] / (ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack([rx, ry], -1))
    return torch.cat(refs, 1)[:, :, None] * ratios[:, None]  # (B, Lv, L, 2)


def forward(p, images, mask, cfg, P) -> Dict:
    """images (B, H, W, 3) normalised, mask (B, H, W) 1 = padded ->
    pred_logits (B, Nq, classes), pred_boxes (B, Nq, 4) relative
    (cx, cy, w, h), and the other decoder layers' under aux_outputs."""
    d, eps = cfg["hidden_dim"], cfg["layer_norm_eps"]
    gn_eps, mode = cfg["group_norm_eps"], cfg["mask_resize"]
    feats = backbone.resnet(images, p, cfg, P)
    srcs, masks = [], []
    for lvl, layer in enumerate(("layer2", "layer3", "layer4")):
        f = feats[layer]
        srcs.append(group_norm(conv2d(f, p, f"input_proj.{lvl}.0", P,
                                      bias=True),
                               p, f"input_proj.{lvl}.1", 32, gn_eps))
        masks.append(resize_mask(mask, f.shape[-2:], mode))
    srcs.append(group_norm(conv2d(feats["layer4"], p, "input_proj.3.0", P,
                                  stride=2, padding=1, bias=True),
                           p, "input_proj.3.1", 32, gn_eps))
    masks.append(resize_mask(masks[-1], srcs[-1].shape[-2:], mode))
    B = images.shape[0]
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    pad = torch.cat([m.reshape(B, -1) for m in masks], 1) >= 0.5
    pos = torch.cat([sine_positions(m, d // 2, center=True).reshape(B, -1, d)
                     + p["transformer.level_embed"][lvl]
                     for lvl, m in enumerate(masks)], 1)
    ratios = _valid_ratios(masks)
    ref = _encoder_reference(shapes, ratios)
    for i in range(cfg["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        a = msda.module(src + pos, ref, src, shapes, pad, p,
                        f"{n}.self_attn", cfg, P)
        src = layer_norm(src + a, p, f"{n}.norm1", eps)
        ff = linear(torch.relu(linear(src, p, f"{n}.linear1", P)), p,
                    f"{n}.linear2", P)
        src = layer_norm(src + ff, p, f"{n}.norm2", eps)
    memory = src

    query_pos, tgt = p["query_embed.weight"].split(d, dim=-1)
    query_pos = query_pos[None].expand(B, -1, -1)
    tgt = tgt[None].expand(B, -1, -1)
    ref = torch.sigmoid(linear(query_pos, p, "transformer.reference_points",
                               P))
    refs, hs = [ref], []
    for i in range(cfg["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        r = ref[:, :, None] * (torch.cat([ratios, ratios], -1)
                               if ref.shape[-1] == 4 else ratios)[:, None]
        q = tgt + query_pos
        tgt = layer_norm(tgt + attention(q, q, tgt, p, f"{n}.self_attn",
                                         cfg["nheads"], P),
                         p, f"{n}.norm2", eps)
        a = msda.module(tgt + query_pos, r, memory, shapes, pad, p,
                        f"{n}.cross_attn", cfg, P)
        tgt = layer_norm(tgt + a, p, f"{n}.norm1", eps)
        ff = linear(torch.relu(linear(tgt, p, f"{n}.linear1", P)), p,
                    f"{n}.linear2", P)
        tgt = layer_norm(tgt + ff, p, f"{n}.norm3", eps)
        delta = mlp(tgt, p, f"bbox_embed.{i}", 3, P)
        if ref.shape[-1] == 4:
            new = torch.sigmoid(delta + inverse_sigmoid(ref))
        else:
            new = torch.cat([torch.sigmoid(delta[..., :2]
                                           + inverse_sigmoid(ref)),
                             torch.sigmoid(delta[..., 2:])], -1)
        ref = new.detach()
        refs.append(ref)
        hs.append(tgt)
    outs = []
    for lvl, h in enumerate(hs):
        r = refs[lvl]
        delta = mlp(h, p, f"bbox_embed.{lvl}", 3, P)
        if r.shape[-1] == 4:
            boxes = torch.sigmoid(delta + inverse_sigmoid(r))
        else:
            boxes = torch.cat([torch.sigmoid(delta[..., :2]
                                             + inverse_sigmoid(r)),
                               torch.sigmoid(delta[..., 2:])], -1)
        outs.append({"pred_logits": linear(h, p, f"class_embed.{lvl}", P),
                     "pred_boxes": boxes})
    return dict(outs[-1], aux_outputs=outs[:-1])


def postprocess(logits, cfg, threshold):
    """Sigmoid-focal inference: the score is the largest class
    probability, the label its class; kept where the score exceeds
    ``threshold``. Returns (labels, scores, keep)."""
    best, labels = logits.float().max(-1)
    scores = torch.sigmoid(best)
    return labels, scores, scores > threshold


def label_scores(logits, labels, cfg):
    return torch.sigmoid(logits.float().gather(-1, labels[..., None])[..., 0])


def msda_fmas(cfg, batch, hw) -> int:
    """Multiply-adds of a forward's deformable attention by the frozen
    formula: four corners a sampling point, one per channel of a head."""
    from ..counting import level_shapes
    shapes = level_shapes(hw, cfg["num_feature_levels"])
    lv = sum(h * w for h, w in shapes)
    per_query = cfg["nheads"] * cfg["num_feature_levels"] * cfg["n_points"] \
        * 4 * (cfg["hidden_dim"] // cfg["nheads"])
    return batch * per_query * (cfg["enc_layers"] * lv
                                + cfg["dec_layers"] * cfg["num_queries"])
