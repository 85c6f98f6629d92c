"""DETR encoder-decoder transformer (counterpart of
``aloception_tpu/models/detr/transformer.py``).

Post-norm, batch-first (B, L, C). Positional embeddings are added to queries
and keys only, never to values; the learned queries are added at every
decoder layer, whose target starts at zeros; the decoder returns every
layer's output after the shared final LayerNorm. Attention is
``nn.MultiheadAttention`` without weights, so it runs
``scaled_dot_product_attention``. Dropout (``dropout``, 0 by default here;
``Detr`` passes 0.1) acts in train mode at the JAX package's places: on the
attention weights, on each sublayer's output before its residual add, and
after the FFN's ReLU. Modules carry the reference ``state_dict`` names
(``encoder.layers.{i}``, ``decoder.layers.{i}.multihead_attn``,
``decoder.norm``).

Under a mesh with sp > 1 (``parallel.use_mesh``) the encoder runs sequence
parallel, as the JAX package's ``constrain_tokens`` hooks make XLA run it:
each rank keeps its slice of the tokens through LayerNorm and the FFN, its
queries attend to every key and value (an all-gather of the layer's input
that carries gradients), and the memory is gathered whole for the decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.shard import (SequenceShard, constrain_tokens,
                               sequence_shard)
from ..transformers import LayerNorm

# flax nn.LayerNorm's default epsilon, which the JAX package uses
LN_EPS = 1e-6


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, nheads: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, nheads,
                                               dropout=dropout,
                                               batch_first=True, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                shard: Optional[SequenceShard] = None) -> torch.Tensor:
        """src, pos: (B, L, C); key_padding_mask: (B, L) bool, True =
        padded (ignored as a key). With a ``shard``, ``src`` holds this
        rank's tokens and ``pos`` all of them."""
        if shard is None:
            q = k = src + pos
            v = src
        else:
            v = shard.gather(src)
            q, k = src + shard.split(pos), v + pos
        src2 = self.self_attn(q, k, v, key_padding_mask=key_padding_mask,
                              need_weights=False)[0]
        src = self.norm1(src + self.dropout(src2))
        src2 = self.linear2(self.dropout(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout(src2))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, nheads: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, nheads,
                                               dropout=dropout,
                                               batch_first=True, device=device)
        self.multihead_attn = nn.MultiheadAttention(
            d_model, nheads, dropout=dropout, batch_first=True, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm3 = LayerNorm(d_model, eps=LN_EPS, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                pos: torch.Tensor, query_pos: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tgt, query_pos: (B, Nq, C); memory, pos: (B, L, C);
        key_padding_mask: (B, L) bool, True = padded."""
        q = k = tgt + query_pos
        tgt2 = self.self_attn(q, k, tgt, need_weights=False)[0]
        tgt = self.norm1(tgt + self.dropout(tgt2))
        tgt2 = self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                   key_padding_mask=key_padding_mask,
                                   need_weights=False)[0]
        tgt = self.norm2(tgt + self.dropout(tgt2))
        tgt2 = self.linear2(self.dropout(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout(tgt2))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(**layer_kwargs)
                                    for _ in range(num_layers))

    def forward(self, src, pos, key_padding_mask=None):
        shard = sequence_shard(src.shape[1])
        for layer in self.layers:
            src = constrain_tokens(src, shard)
            src = layer(src, pos, key_padding_mask, shard)
        return src if shard is None else shard.gather(src)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int = 256, device=None,
                 **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model=d_model, device=device, **layer_kwargs)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, tgt, memory, pos, query_pos, key_padding_mask=None):
        intermediates = []
        for layer in self.layers:
            tgt = layer(tgt, memory, pos, query_pos, key_padding_mask)
            intermediates.append(self.norm(tgt))
        return torch.stack(intermediates)


class Transformer(nn.Module):
    def __init__(self, d_model: int = 256, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 device=None):
        super().__init__()
        layer_kwargs = dict(d_model=d_model, nheads=nheads,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            device=device)
        self.encoder = TransformerEncoder(num_encoder_layers, **layer_kwargs)
        self.decoder = TransformerDecoder(num_decoder_layers, **layer_kwargs)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                query_embed: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """src, pos: (B, L, C) flattened features and their positions;
        query_embed: (Nq, C) learned queries; key_padding_mask: (B, L),
        1 = padded. Returns (decoder outputs (layers, B, Nq, C), encoder
        memory (B, L, C))."""
        if key_padding_mask is not None:
            key_padding_mask = key_padding_mask >= 0.5
        memory = self.encoder(src, pos, key_padding_mask)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        hs = self.decoder(tgt, memory, pos, query_pos, key_padding_mask)
        return hs, memory
