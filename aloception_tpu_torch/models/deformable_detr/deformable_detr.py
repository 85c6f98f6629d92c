"""Deformable DETR (counterpart of
``aloception_tpu/models/deformable_detr/deformable_detr.py``).

Multi-scale (4-level) input projections with GroupNorm, 300 queries from a
2x-hidden embedding, sigmoid-focal classification (or, with
``activation_fn="softmax"``, softmax over the classes and a background
class), optional iterative box refinement through per-layer box heads wired
into the decoder. With
``return_intermediate`` the backbone returns layer1-4 (the levels stay
C3-C5) and the output dict carries what the panoptic head reads. Parameters
carry the reference ``state_dict`` names (``backbone.0.body.*``,
``input_proj.{l}.0/1``, ``query_embed.weight``, ``transformer.*``,
``class_embed.{i}``, ``bbox_embed.{i}.layers.{j}``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...aloscene import BoundingBoxes2D
from ...utils.profiling import span
from ..backbone.resnet import Backbone
from ..detr.detr import boxes_per_image
from ..detr.detr import inference as detr_inference
from ..transformers import (MLP, GroupNorm, entry_device, init_parameters,
                            position_embedding_sine)
from .deformable_transformer import DeformableTransformer, inverse_sigmoid
from .ms_deform_attn import MSDeformAttn

NUM_FEATURE_LEVELS = 4   # C3, C4, C5 and a stride-2 conv on C5


class DeformableDETR(nn.Module):
    def __init__(self, num_classes: int = 91, hidden_dim: int = 256,
                 num_queries: int = 300, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, n_points: int = 4,
                 dropout: float = 0.1, with_box_refine: bool = False,
                 return_intermediate: bool = False,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 activation_fn: str = "sigmoid", device=None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are drawn from ``generator`` (a fresh one seeded with 0
        on ``device`` when None). ``dropout`` acts in train mode only.
        ``activation_fn`` "sigmoid" (focal) gives ``num_classes`` logits,
        "softmax" ``num_classes + 1``, the last the background class."""
        super().__init__()
        if activation_fn not in ("sigmoid", "softmax"):
            raise ValueError(f"activation_fn {activation_fn!r}: sigmoid or "
                             "softmax")
        self.activation_fn = activation_fn
        self.hidden_dim = hidden_dim
        self.nheads = nheads
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.return_intermediate = return_intermediate
        layers = ("layer2", "layer3", "layer4")
        if return_intermediate:
            layers = ("layer1",) + layers
        self.backbone = nn.ModuleList([Backbone(layers, stage_sizes,
                                                device=device)])
        in_channels = (512, 1024, 2048)
        self.input_proj = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, hidden_dim, 1, device=device),
                           GroupNorm(32, hidden_dim, device=device))
             for c in in_channels]
            + [nn.Sequential(nn.Conv2d(in_channels[-1], hidden_dim, 3,
                                       stride=2, padding=1, device=device),
                             GroupNorm(32, hidden_dim, device=device))])
        self.query_embed = nn.Embedding(num_queries, 2 * hidden_dim,
                                        device=device)
        self.transformer = DeformableTransformer(
            hidden_dim, nheads, num_encoder_layers, num_decoder_layers,
            dim_feedforward, NUM_FEATURE_LEVELS, n_points, dropout,
            device=device)

        # heads: per-layer clones for refinement, else one module repeated
        # (the reference's ModuleList of one shared module)
        def class_head():
            return nn.Linear(hidden_dim, num_classes + (
                activation_fn == "softmax"), device=device)

        def box_head():
            return MLP(hidden_dim, hidden_dim, 4, 3, device=device)

        if with_box_refine:
            self.class_embed = nn.ModuleList(class_head()
                                             for _ in range(num_decoder_layers))
            self.bbox_embed = nn.ModuleList(box_head()
                                            for _ in range(num_decoder_layers))
            self.transformer.decoder.bbox_embed = self.bbox_embed
        else:
            c, b = class_head(), box_head()
            self.class_embed = nn.ModuleList([c] * num_decoder_layers)
            self.bbox_embed = nn.ModuleList([b] * num_decoder_layers)

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        _init_parameters(self, generator)

    @property
    def background_class(self) -> Optional[int]:
        """The softmax head's background class; None for the sigmoid one."""
        return self.num_classes if self.activation_fn == "softmax" else None

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict:
        """images: (B, H, W, 3) normalised; mask: (B, H, W), 1 = padded.
        Returns pred_logits (B, Nq, classes), pred_boxes (B, Nq, 4) as
        relative (cx, cy, w, h) in float32, and the other decoder layers'
        outputs under aux_outputs. With return_intermediate also
        dec_outputs, enc_outputs (B, Lv, C), and at the C5 level, the one
        the panoptic head reads: enc_outputs_spatial (B, Hp, Wp, C), proj_src
        (its projected map after GroupNorm, NHWC) and feat_mask; bb_outputs
        and bb_masks (layer1-3, fine to coarse, NHWC)."""
        dtype = self.query_embed.weight.dtype
        with span("alo.model.backbone"):
            feats = self.backbone[0](images.to(dtype), mask)
        srcs, masks = [], []
        for lvl, (f, m) in enumerate(feats[-3:]):     # C3, C4, C5
            srcs.append(self.input_proj[lvl](f.permute(0, 3, 1, 2)))
            masks.append(m)
        # extra level: stride-2 conv on C5
        srcs.append(self.input_proj[-1](feats[-1][0].permute(0, 3, 1, 2)))
        masks.append(F.interpolate(masks[-1][:, None], size=srcs[-1].shape[-2:],
                                   mode="nearest-exact")[:, 0])
        pos_embeds = [position_embedding_sine(
            m, num_pos_feats=self.hidden_dim // 2, center=True, dtype=dtype)
            for m in masks]

        with span("alo.model.transformer"):
            hs, init_reference, inter_references, memory, spatial_shapes, _ \
                = self.transformer([s.permute(0, 2, 3, 1) for s in srcs],
                                   masks, pos_embeds, self.query_embed.weight)

        all_logits, all_boxes = [], []
        for lvl in range(self.num_decoder_layers):
            ref = init_reference if lvl == 0 else inter_references[lvl - 1]
            logits = self.class_embed[lvl](hs[lvl])
            delta = self.bbox_embed[lvl](hs[lvl]).float()
            if ref.shape[-1] == 4:
                boxes = torch.sigmoid(delta + inverse_sigmoid(ref))
            else:
                xy = torch.sigmoid(delta[..., :2] + inverse_sigmoid(ref))
                boxes = torch.cat([xy, torch.sigmoid(delta[..., 2:])], -1)
            all_logits.append(logits)
            all_boxes.append(boxes)

        out = {"pred_logits": all_logits[-1], "pred_boxes": all_boxes[-1],
               "aux_outputs": [{"pred_logits": l, "pred_boxes": b}
                               for l, b in zip(all_logits[:-1],
                                               all_boxes[:-1])]}
        if self.return_intermediate:
            plvl = len(srcs) - 2
            start = sum(h * w for h, w in spatial_shapes[:plvl])
            Hp, Wp = spatial_shapes[plvl]
            out.update(
                dec_outputs=hs, enc_outputs=memory,
                enc_outputs_spatial=memory[:, start:start + Hp * Wp].reshape(
                    memory.shape[0], Hp, Wp, self.hidden_dim),
                proj_src=srcs[plvl].permute(0, 2, 3, 1),
                feat_mask=masks[plvl],
                bb_outputs=[f for f, _ in feats[:-1]],
                bb_masks=[m for _, m in feats[:-1]])
        return out


@torch.no_grad()
def _init_parameters(model: "DeformableDETR", generator: torch.Generator):
    """The shared random init, then Deformable-DETR's own: N(0, 1) level
    embeddings; every MSDeformAttn zeroes its offset and weight kernels and
    grid-initialises its offset bias."""
    init_parameters(model, generator)
    model.transformer.level_embed.normal_(0.0, 1.0, generator=generator)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.reset_offsets()


def deformable_detr_r50(num_classes: int = 91, with_box_refine: bool = False,
                        dtype: torch.dtype = torch.float32, device=None,
                        generator: Optional[torch.Generator] = None,
                        **kwargs) -> DeformableDETR:
    """Deformable-DETR-R50 (± box refinement) in eval mode, its parameters in
    ``dtype`` except the reference-point projection, which stays float32 as
    in the JAX package; 4-d parameters get channels_last strides. It builds
    on the CUDA card unless ``device`` names another (``device="cpu"``); with
    no device and no card it raises."""
    model = DeformableDETR(num_classes=num_classes,
                           with_box_refine=with_box_refine,
                           device=entry_device(device),
                           generator=generator, **kwargs)
    model.to(dtype=dtype, memory_format=torch.channels_last)
    model.transformer.reference_points.float()
    return model.eval()


def inference(m_outputs: Dict, threshold: float = 0.2,
              activation_fn: str = "sigmoid") -> List[BoundingBoxes2D]:
    """Sigmoid-focal inference: score = max sigmoid(logit) over classes, keep
    score > threshold. Returns per image relative (cx, cy, w, h)
    ``BoundingBoxes2D`` with float32 ``Labels`` carrying the scores. With
    ``activation_fn="softmax"`` it is DETR's inference, the last logit the
    background class."""
    if activation_fn == "softmax":
        return detr_inference(
            m_outputs, threshold=threshold,
            background_class=m_outputs["pred_logits"].shape[-1] - 1)
    with span("alo.model.inference"):
        scores, labels = m_outputs["pred_logits"].float().sigmoid().max(-1)
        return boxes_per_image(m_outputs["pred_boxes"], labels, scores,
                               scores > threshold)
