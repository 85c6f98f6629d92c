"""Shared transformer building blocks (counterpart of
``aloception_tpu/models/transformers.py``).

- MLP: multi-layer perceptron head, reference parameter names
  ``layers.{j}``.
- position_embedding_sine: 2-D sine positional encoding computed from the
  *non-padded* area of the padding mask via cumulative sums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

TEMPERATURE = 10000.0
SCALE = 2 * math.pi
EPS = 1e-6


class MLP(nn.Module):
    """input_dim -> hidden_dim x (num_layers - 1) -> output_dim, ReLU between."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, device=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int = 64,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mask: (B, H, W), 1 = PADDED. Returns (B, H, W, 2 * num_pos_feats),
    channels last, computed in float32 and cast to ``dtype``. Positions are
    centred (cumsum - 0.5) and normalised to [0, 2*pi]: Deformable-DETR's
    variant (the JAX function with ``center=True``)."""
    not_mask = 1.0 - mask.float()
    y_embed = not_mask.cumsum(1) - 0.5
    x_embed = not_mask.cumsum(2) - 0.5
    y_embed = y_embed / (y_embed[:, -1:, :] + EPS) * SCALE
    x_embed = x_embed / (x_embed[:, :, -1:] + EPS) * SCALE

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = TEMPERATURE ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)
