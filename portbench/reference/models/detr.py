"""DETR-R50 (facebookresearch/detr, ``hubconf.py::detr_resnet50``) in
plain float32: ResNet-50 C5 -> 1x1 projection -> sine positions -> 6 + 6
post-norm transformer with 100 learned queries -> a softmax class head
with a background class and a 3-layer box MLP on every decoder layer.
Departures from the published code are the configuration's (``reduced``):
LayerNorm's epsilon and how the padding mask is resized."""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import backbone
from ..nn import attention, conv2d, layer_norm, linear, mlp, resize_mask, \
    sine_positions


def _attn_specs(name, d):
    return [(f"{name}.in_proj_weight", (3 * d, d), "xavier"),
            (f"{name}.in_proj_bias", (3 * d,), "zeros"),
            (f"{name}.out_proj.weight", (d, d), "lecun"),
            (f"{name}.out_proj.bias", (d,), "zeros")]


def _linear_specs(name, cout, cin):
    return [(f"{name}.weight", (cout, cin), "lecun"),
            (f"{name}.bias", (cout,), "zeros")]


def _norm_specs(name, d):
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def param_specs(cfg) -> List:
    d, ff = cfg["hidden_dim"], cfg["dim_feedforward"]
    specs = backbone.param_specs(cfg["stage_sizes"])
    specs += [("input_proj.weight", (d, 2048, 1, 1), "lecun"),
              ("input_proj.bias", (d,), "zeros"),
              ("query_embed.weight", (cfg["num_queries"], d), "normal")]
    for i in range(cfg["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        specs += _attn_specs(f"{n}.self_attn", d)
        specs += _linear_specs(f"{n}.linear1", ff, d)
        specs += _linear_specs(f"{n}.linear2", d, ff)
        specs += _norm_specs(f"{n}.norm1", d) + _norm_specs(f"{n}.norm2", d)
    for i in range(cfg["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        specs += _attn_specs(f"{n}.self_attn", d)
        specs += _attn_specs(f"{n}.multihead_attn", d)
        specs += _linear_specs(f"{n}.linear1", ff, d)
        specs += _linear_specs(f"{n}.linear2", d, ff)
        for k in (1, 2, 3):
            specs += _norm_specs(f"{n}.norm{k}", d)
    specs += _norm_specs("transformer.decoder.norm", d)
    specs += _linear_specs("class_embed", cfg["num_classes"] + 1, d)
    for j, cout in enumerate((d, d, 4)):
        specs += _linear_specs(f"bbox_embed.layers.{j}", cout, d)
    return specs


def aliases(cfg) -> Dict[str, str]:
    return {}


def forward(p, images, mask, cfg, P) -> Dict:
    """images (B, H, W, 3) normalised, mask (B, H, W) 1 = padded ->
    pred_logits (B, Nq, classes + 1), pred_boxes (B, Nq, 4) relative
    (cx, cy, w, h), and the other decoder layers' under aux_outputs."""
    d, nh, eps = cfg["hidden_dim"], cfg["nheads"], cfg["layer_norm_eps"]
    c5 = backbone.resnet(images, p, cfg, P)["layer4"]
    m = resize_mask(mask, c5.shape[-2:], cfg["mask_resize"])
    src = conv2d(c5, p, "input_proj", P, bias=True).permute(0, 2, 3, 1)
    pos = sine_positions(m, d // 2, center=False)
    B, H, W, _ = src.shape
    src, pos = src.reshape(B, H * W, d), pos.reshape(B, H * W, d)
    pad = m.reshape(B, H * W) >= 0.5
    for i in range(cfg["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        q = src + pos
        src = layer_norm(src + attention(q, q, src, p, f"{n}.self_attn", nh,
                                         P, pad), p, f"{n}.norm1", eps)
        ff = linear(torch.relu(linear(src, p, f"{n}.linear1", P)), p,
                    f"{n}.linear2", P)
        src = layer_norm(src + ff, p, f"{n}.norm2", eps)
    memory = src
    query_pos = p["query_embed.weight"][None].expand(B, -1, -1)
    tgt = torch.zeros_like(query_pos)
    hs = []
    for i in range(cfg["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        q = tgt + query_pos
        tgt = layer_norm(tgt + attention(q, q, tgt, p, f"{n}.self_attn", nh,
                                         P), p, f"{n}.norm1", eps)
        tgt = layer_norm(tgt + attention(tgt + query_pos, memory + pos,
                                         memory, p, f"{n}.multihead_attn",
                                         nh, P, pad), p, f"{n}.norm2", eps)
        ff = linear(torch.relu(linear(tgt, p, f"{n}.linear1", P)), p,
                    f"{n}.linear2", P)
        tgt = layer_norm(tgt + ff, p, f"{n}.norm3", eps)
        hs.append(layer_norm(tgt, p, "transformer.decoder.norm", eps))
    outs = [{"pred_logits": linear(h, p, "class_embed", P),
             "pred_boxes": torch.sigmoid(mlp(h, p, "bbox_embed", 3, P))}
            for h in hs]
    return dict(outs[-1], aux_outputs=outs[:-1])


def postprocess(logits, cfg, threshold):
    """Published DETR's ``PostProcess`` with the port's keep rule: softmax
    over the classes and the background class; the label is the argmax, its
    probability the score; kept where the label is not the background and
    the score exceeds ``threshold``. Returns (labels, scores, keep)."""
    bg = cfg["num_classes"]
    scores, labels = logits.float().softmax(-1).max(-1)
    return labels, scores, (labels != bg) & (scores > threshold)


def label_scores(logits, labels, cfg):
    """The score of each given label (softmax probability)."""
    return logits.float().softmax(-1).gather(-1, labels[..., None])[..., 0]


def msda_fmas(cfg, batch, hw) -> int:
    """DETR has no deformable attention."""
    return 0
