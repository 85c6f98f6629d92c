"""DETR: end-to-end detection transformer (counterpart of
``aloception_tpu/models/detr/detr.py``).

Frozen-BN ResNet-50 backbone (``layer4`` only) -> 1x1 input projection to
hidden_dim -> uncentred sine positions -> 6+6 post-norm transformer with 100
learned queries -> class head (num_classes + 1, softmax with a background
class) and 3-layer box MLP with sigmoid (relative cx, cy, w, h), applied to
every decoder layer. With ``return_intermediate`` the backbone returns
layer1-4 and the output dict carries what the panoptic head reads (the
decoder outputs, the encoder memory, the projected C5 map and the layer1-3
features). ``inference`` turns the outputs into per-image
``BoundingBoxes2D`` + ``Labels``. Parameters carry the reference
``state_dict`` names (``backbone.0.body.*``, ``input_proj``,
``query_embed.weight``, ``transformer.*``, ``class_embed``,
``bbox_embed.layers.{j}``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...aloscene import BoundingBoxes2D, Labels
from ...utils.profiling import span
from ..backbone.resnet import Backbone
from ..transformers import (MLP, entry_device, init_parameters,
                            position_embedding_sine)
from .transformer import Transformer


class Detr(nn.Module):
    def __init__(self, num_classes: int = 91, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 aux_loss: bool = True, return_intermediate: bool = False,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), device=None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are drawn from ``generator`` (a fresh one seeded with 0
        on ``device`` when None). ``dropout`` acts in train mode only."""
        super().__init__()
        self.hidden_dim = hidden_dim
        self.nheads = nheads
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.aux_loss = aux_loss
        self.return_intermediate = return_intermediate
        layers = ("layer1", "layer2", "layer3", "layer4") \
            if return_intermediate else ("layer4",)
        self.backbone = nn.ModuleList([Backbone(layers, stage_sizes,
                                                device=device)])
        self.input_proj = nn.Conv2d(2048, hidden_dim, 1, device=device)
        self.query_embed = nn.Embedding(num_queries, hidden_dim, device=device)
        self.transformer = Transformer(hidden_dim, nheads, num_encoder_layers,
                                       num_decoder_layers, dim_feedforward,
                                       dropout, device=device)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1,
                                     device=device)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(self, generator)

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict:
        """images: (B, H, W, 3) normalised; mask: (B, H, W), 1 = padded.
        Returns pred_logits (B, Nq, num_classes + 1) and pred_boxes (B, Nq, 4)
        as relative (cx, cy, w, h), in the parameters' dtype, and, with
        aux_loss, the other decoder layers' outputs under aux_outputs. With
        return_intermediate also dec_outputs (layers, B, Nq, C),
        enc_outputs (B, H, W, C), proj_src (B, H, W, C), bb_outputs and
        bb_masks (layer1-3, fine to coarse, NHWC) and feat_mask (B, H, W)."""
        dtype = self.query_embed.weight.dtype
        with span("alo.model.backbone"):
            feats = self.backbone[0](images.to(dtype), mask)
        src, feat_mask = feats[-1]
        src = self.input_proj(src.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        pos = position_embedding_sine(feat_mask,
                                      num_pos_feats=self.hidden_dim // 2,
                                      dtype=dtype)
        B, H, W, C = src.shape
        with span("alo.model.transformer"):
            hs, memory = self.transformer(src.reshape(B, H * W, C),
                                          pos.reshape(B, H * W, C),
                                          self.query_embed.weight,
                                          feat_mask.reshape(B, H * W))
        logits = self.class_embed(hs)                  # (L, B, Nq, C + 1)
        boxes = torch.sigmoid(self.bbox_embed(hs))     # (L, B, Nq, 4)
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss:
            out["aux_outputs"] = [{"pred_logits": l, "pred_boxes": b}
                                  for l, b in zip(logits[:-1], boxes[:-1])]
        if self.return_intermediate:
            out.update(dec_outputs=hs, enc_outputs=memory.reshape(B, H, W, C),
                       proj_src=src, bb_outputs=[f for f, _ in feats[:-1]],
                       bb_masks=[m for _, m in feats[:-1]],
                       feat_mask=feat_mask)
        return out


def detr_r50(num_classes: int = 91, aux_loss: bool = True,
             dtype: torch.dtype = torch.float32, device=None,
             generator: Optional[torch.Generator] = None, **kwargs) -> Detr:
    """DETR-R50 in eval mode, its parameters in ``dtype``; 4-d parameters get
    channels_last strides. It builds on the CUDA card unless ``device`` names
    another (``device="cpu"``); with no device and no card it raises."""
    model = Detr(num_classes=num_classes, aux_loss=aux_loss,
                 device=entry_device(device),
                 generator=generator, **kwargs)
    model.to(dtype=dtype, memory_format=torch.channels_last)
    return model.eval()


def kept_queries(keep: torch.Tensor, device: torch.device
                 ) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
    """keep (B, Nq) -> (kept queries per image, their batch and query
    indices on ``device``). The copy of ``keep`` is the one host sync."""
    keep = keep.cpu()
    b_idx, q_idx = (i.to(device, non_blocking=True)
                    for i in keep.nonzero(as_tuple=True))
    return keep.sum(1).tolist(), b_idx, q_idx


def boxes_per_image(boxes: torch.Tensor, labels: torch.Tensor,
                    scores: torch.Tensor, keep: torch.Tensor
                    ) -> List[BoundingBoxes2D]:
    """Per image b, the queries where ``keep[b]``: relative (cx, cy, w, h)
    ``BoundingBoxes2D`` with float32 ``Labels`` and their ``scores``.

    boxes (B, Nq, 4), labels, scores and keep (B, Nq). The one host sync is
    the copy of ``keep``; the kept queries are gathered on the device."""
    return boxes_of_kept(boxes, labels, scores,
                         *kept_queries(keep, boxes.device))


def boxes_of_kept(boxes: torch.Tensor, labels: torch.Tensor,
                  scores: torch.Tensor, counts: List[int],
                  b_idx: torch.Tensor, q_idx: torch.Tensor
                  ) -> List[BoundingBoxes2D]:
    """``boxes_per_image`` for the queries ``kept_queries`` returned."""
    kept = zip(boxes[b_idx, q_idx].float().split(counts),
               labels[b_idx, q_idx].float().split(counts),
               scores[b_idx, q_idx].float().split(counts))
    return [BoundingBoxes2D(b, boxes_format="xcyc", absolute=False,
                            labels=Labels(l, scores=s))
            for b, l, s in kept]


def inference_arrays(m_outputs: Dict, background_class: int = 91
                     ) -> Tuple[torch.Tensor, ...]:
    """Static-shape half of ``inference``: (boxes, labels, scores, keep),
    each (B, Nq, ...): softmax over classes, argmax label and its
    probability, and keep = the label is not the background class."""
    probs = m_outputs["pred_logits"].float().softmax(-1)
    scores, labels = probs.max(-1)
    return (m_outputs["pred_boxes"], labels, scores,
            labels != background_class)


def inference(m_outputs: Dict, threshold: float = 0.0,
              background_class: int = 91) -> List[BoundingBoxes2D]:
    """Model outputs -> per image ``BoundingBoxes2D`` + ``Labels``: a query
    is kept when its argmax class is not the background class and its
    softmax score exceeds ``threshold``."""
    with span("alo.model.inference"):
        boxes, labels, scores, keep = inference_arrays(m_outputs,
                                                       background_class)
        return boxes_per_image(boxes, labels, scores,
                               keep & (scores > threshold))
