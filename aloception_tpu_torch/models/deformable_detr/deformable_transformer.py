"""Deformable transformer (counterpart of
``aloception_tpu/models/deformable_detr/deformable_transformer.py``):
multi-scale encoder with per-level reference points and valid ratios, decoder
with MSDeformAttn cross-attention and optional iterative box refinement.

Dropout (``dropout``, 0 by default here; ``DeformableDETR`` passes 0.1) acts
in train mode at the JAX package's places: on each sublayer's output before
its residual add, after the FFN's ReLU, and on the decoder self-attention's
weights.

Modules and parameters carry the reference ``state_dict`` names
(``encoder.layers.{i}``, ``decoder.layers.{i}``, ``level_embed``,
``reference_points``; with refinement the decoder holds the model's
``bbox_embed`` as ``decoder.bbox_embed``).

Under a mesh with sp > 1 (``parallel.use_mesh``) the encoder runs sequence
parallel: each rank keeps its slice of the queries (tokens, positions and
reference points) through LayerNorm, the FFN and MSDA, whose value is
projected from the layer's whole input (an all-gather that carries
gradients); the MSDA kernel then runs at Lq / sp queries. The memory is
gathered whole for the decoder.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.shard import (SequenceShard, constrain_tokens,
                               sequence_shard)
from ..transformers import LayerNorm

from .ms_deform_attn import MSDeformAttn

# flax nn.LayerNorm's default epsilon, which the JAX package uses
LN_EPS = 1e-6


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(1e-5, 1 - 1e-5)
    return torch.log(x / (1 - x))


def get_valid_ratios(masks: List[torch.Tensor]) -> torch.Tensor:
    """Unpadded fraction of each level's H and W. masks: list of (B, H_l, W_l),
    1 = padded. Returns (B, L, 2) as (ratio_w, ratio_h)."""
    ratios = []
    for m in masks:
        not_m = 1.0 - m.float()
        valid_h = not_m[:, :, 0].sum(1)
        valid_w = not_m[:, 0, :].sum(1)
        ratios.append(torch.stack([valid_w / m.shape[2], valid_h / m.shape[1]],
                                  -1))
    return torch.stack(ratios, 1)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-pixel normalised reference points of every level, each level's grid
    normalised by that level's valid ratio. Returns (B, Lv, L, 2)."""
    ref_list = []
    dev = valid_ratios.device
    for lvl, (H, W) in enumerate(spatial_shapes):
        ys, xs = torch.meshgrid(
            torch.linspace(0.5, H - 0.5, H, dtype=torch.float32, device=dev),
            torch.linspace(0.5, W - 0.5, W, dtype=torch.float32, device=dev),
            indexing="ij")
        ref_y = ys.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * H)
        ref_x = xs.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * W)
        ref_list.append(torch.stack([ref_x, ref_y], -1))
    ref = torch.cat(ref_list, 1)                      # (B, Lv, 2)
    return ref[:, :, None] * valid_ratios[:, None]    # (B, Lv, L, 2)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, dim_feedforward: int = 1024,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      device=device)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None, shard: Optional[SequenceShard] = None):
        """With a ``shard``, ``src`` and ``reference_points`` hold this
        rank's queries, ``pos`` all of them."""
        if shard is None:
            src2 = self.self_attn(src + pos, reference_points, src,
                                  spatial_shapes, padding_mask)
        else:
            src2 = self.self_attn(src + shard.split(pos), reference_points,
                                  shard.gather(src), spatial_shapes,
                                  padding_mask)
        src = self.norm1(src + self.dropout(src2))
        src2 = self.linear2(self.dropout(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout(src2))


class DeformableDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, dim_feedforward: int = 1024,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       device=device)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.self_attn = nn.MultiheadAttention(d_model, n_heads,
                                               dropout=dropout,
                                               batch_first=True, device=device)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm3 = LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask=None):
        q = k = tgt + query_pos
        tgt2 = self.self_attn(q, k, tgt, need_weights=False)[0]
        tgt = self.norm2(tgt + self.dropout(tgt2))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src,
                               spatial_shapes, src_padding_mask)
        tgt = self.norm1(tgt + self.dropout(tgt2))
        tgt2 = self.linear2(self.dropout(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout(tgt2))


class DeformableTransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(**layer_kwargs)
                                    for _ in range(num_layers))

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None):
        shard = sequence_shard(src.shape[1])
        reference_points = constrain_tokens(reference_points, shard)
        for layer in self.layers:
            src = constrain_tokens(src, shard)
            src = layer(src, pos, reference_points, spatial_shapes,
                        padding_mask, shard)
        return src if shard is None else shard.gather(src)


class DeformableTransformerDecoder(nn.Module):
    """Decoder stack. ``bbox_embed`` (set by the model when it refines boxes)
    holds one box head per layer; after each layer it moves the reference
    points, which become 4-d (cx, cy, w, h) from the first layer on."""

    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(DeformableDecoderLayer(**layer_kwargs)
                                    for _ in range(num_layers))
        self.bbox_embed: Optional[nn.ModuleList] = None

    def forward(self, tgt, reference_points, src, spatial_shapes, valid_ratios,
                query_pos, src_padding_mask=None):
        intermediates, inter_refs = [], []
        for i, layer in enumerate(self.layers):
            if reference_points.shape[-1] == 4:
                ref_input = reference_points[:, :, None] * torch.cat(
                    [valid_ratios, valid_ratios], -1)[:, None]
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            tgt = layer(tgt, query_pos, ref_input, src, spatial_shapes,
                        src_padding_mask)
            if self.bbox_embed is not None:
                delta = self.bbox_embed[i](tgt)
                if reference_points.shape[-1] == 4:
                    new_ref = torch.sigmoid(
                        delta + inverse_sigmoid(reference_points))
                else:
                    xy = torch.sigmoid(delta[..., :2]
                                       + inverse_sigmoid(reference_points))
                    new_ref = torch.cat(
                        [xy, torch.sigmoid(delta[..., 2:]).float()], -1)
                reference_points = new_ref.detach()
            intermediates.append(tgt)
            inter_refs.append(reference_points)
        return torch.stack(intermediates), torch.stack(inter_refs)


class DeformableTransformer(nn.Module):
    """Returns (hs (layers, B, Nq, d), init_reference (B, Nq, 2),
    inter_references (layers, B, Nq, 2|4), memory (B, Lv, d), spatial_shapes,
    valid_ratios (B, L, 2))."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, n_levels: int = 4,
                 n_points: int = 4, dropout: float = 0.0, device=None):
        super().__init__()
        self.d_model = d_model
        layer_kwargs = dict(d_model=d_model, dim_feedforward=dim_feedforward,
                            n_levels=n_levels, n_heads=n_heads,
                            n_points=n_points, dropout=dropout, device=device)
        self.encoder = DeformableTransformerEncoder(num_encoder_layers,
                                                    **layer_kwargs)
        self.decoder = DeformableTransformerDecoder(num_decoder_layers,
                                                    **layer_kwargs)
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model,
                                                    device=device))
        # kept in float32 by the model's dtype cast, as the JAX package does
        self.reference_points = nn.Linear(d_model, 2, device=device)
        self.reference_points.keep_float32 = True

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor):
        """srcs/pos_embeds: per-level NHWC maps; masks: per-level (B, H, W);
        query_embed: (Nq, 2 * d)."""
        B = srcs[0].shape[0]
        d = self.d_model
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)

        src = torch.cat([s.reshape(B, -1, d) for s in srcs], 1)
        mask = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos = torch.cat([p.reshape(B, -1, d) + self.level_embed[lvl].to(p.dtype)
                         for lvl, p in enumerate(pos_embeds)], 1)

        valid_ratios = get_valid_ratios(masks)
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = self.encoder(src, pos, enc_ref, spatial_shapes, mask)

        query_pos, tgt = torch.split(query_embed, d, dim=-1)
        query_pos = query_pos[None].expand(B, -1, -1)
        tgt = tgt[None].expand(B, -1, -1)
        ref_dtype = self.reference_points.weight.dtype
        init_reference = torch.sigmoid(
            self.reference_points(query_pos.to(ref_dtype)))

        hs, inter_refs = self.decoder(tgt, init_reference, memory,
                                      spatial_shapes, valid_ratios, query_pos,
                                      mask)
        return (hs, init_reference, inter_refs, memory, spatial_shapes,
                valid_ratios)
