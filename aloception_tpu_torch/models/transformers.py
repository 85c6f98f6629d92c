"""Shared transformer building blocks (counterpart of
``aloception_tpu/models/transformers.py``).

- MLP: multi-layer perceptron head, reference parameter names
  ``layers.{j}``.
- position_embedding_sine: 2-D sine positional encoding computed from the
  *non-padded* area of the padding mask via cumulative sums.
- init_parameters: the detectors' random init from one explicit generator.
- LayerNorm, GroupNorm and cast_for_training: a model in a low precision
  for a train step, computing where flax computes in float32 (its norms)
  in float32.
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


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes in its parameters' dtype: under
    ``cast_for_training`` they stay float32 while the model computes in
    bfloat16, and the input is widened and the output cast back, as flax
    computes a norm (statistics, scale and bias in float32, the output in
    the model's dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that computes in its parameters' dtype, as
    ``LayerNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


@torch.no_grad()
def set_data_(p: nn.Parameter, value: torch.Tensor) -> nn.Parameter:
    """Make ``value`` (of any dtype) the data of the parameter ``p``, the
    same object. A DTensor parameter is swapped whole: its ``.data`` would
    change its dtype and leave its local tensor as it was."""
    if hasattr(p, "_local_tensor"):
        torch.utils.swap_tensors(p, nn.Parameter(
            value.detach(), requires_grad=p.requires_grad))
    else:
        p.data = value
    return p


def float32_kept(model: nn.Module) -> set:
    """The ids of the parameters and buffers of ``model`` that
    ``cast_for_training`` leaves in float32."""
    kept = set()
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)) \
                or getattr(m, "keep_float32", False):
            kept.update(id(x) for x in (*m.parameters(), *m.buffers()))
    return kept


def cast_for_training(model: nn.Module, dtype: torch.dtype,
                      skip=()) -> nn.Module:
    """``model`` computing in ``dtype`` as flax computes a model built with
    ``dtype`` over float32 parameters: its parameters and buffers in
    ``dtype`` (a train step's optimizer keeps their float32 masters, see
    ``train.state.TrainOptimizer``), except what flax computes in float32:
    the norms (their statistics, scale and bias), and modules whose
    ``keep_float32`` is set (the frozen BatchNorm fold, Deformable-DETR's
    reference-point projection), which are not rounded on the way. The
    parameters whose ids are in ``skip`` are left as they are (FSDP's
    shards, which its mixed-precision policy casts where they are
    gathered). Returns ``model``."""
    kept = float32_kept(model)
    skip = set(skip)
    with torch.no_grad():
        for m in model.modules():
            for p in m.parameters(recurse=False):
                if p.is_floating_point() and id(p) not in skip:
                    set_data_(p, p.detach().to(torch.float32 if id(p) in kept
                                               else dtype))
            for name, b in m.named_buffers(recurse=False):
                if b.is_floating_point():
                    m._buffers[name] = b.to(torch.float32 if id(b) in kept
                                            else dtype)
    return model


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int = 64,
                            center: bool = False,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mask: (B, H, W), 1 = PADDED. Returns (B, H, W, 2 * num_pos_feats),
    channels last, computed in float32 and cast to ``dtype``. Positions are
    normalised to [0, 2*pi]; ``center`` moves them to pixel centres
    (cumsum - 0.5), as Deformable-DETR does; DETR does not."""
    not_mask = 1.0 - mask.float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if center:
        y_embed = y_embed - 0.5
        x_embed = x_embed - 0.5
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


def entry_device(device) -> torch.device:
    """The device a model factory builds on: ``device``, or the CUDA card
    when it is None. Without a card, None raises: the CPU is only taken when
    the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card: pass device="cpu" to build the '
                               'model on the CPU')
        device = "cuda"
    return torch.device(device)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """Random init from one explicit generator: LeCun-normal conv and linear
    kernels (flax's default), zero biases, unit norms, N(0, 1) embeddings,
    Xavier-uniform packed attention projections."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.MultiheadAttention):
            bound = math.sqrt(6.0 / (m.in_proj_weight.shape[0] // 3
                                     + m.in_proj_weight.shape[1]))
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
