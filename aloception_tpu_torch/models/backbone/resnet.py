"""ResNet backbone with frozen BatchNorm (counterpart of
``aloception_tpu/models/backbone/resnet.py``).

torchvision ResNet-50 with ``FrozenBatchNorm2d``, under the reference
``state_dict`` names (``conv1``, ``bn1``, ``layer{i}.{j}.conv1``,
``layer{i}.{j}.downsample.0`` ...). Convolutions run NCHW on tensors with
channels_last strides; ``Backbone`` takes and returns NHWC like the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine parameters, all buffers
    (reference ``FrozenBatchNorm2d``). The fold is computed in float32, and
    a model cast for a train step keeps the buffers in float32, as the flax
    module keeps its (frozen) parameters."""

    keep_float32 = True

    def __init__(self, features: int, device=None):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill,
                                                  device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float() / torch.sqrt(self.running_var.float() + BN_EPS)
        b = self.bias.float() - self.running_mean.float() * w
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, device=None):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                     device=device)


class Bottleneck(nn.Module):
    """torchvision bottleneck block (1x1 -> 3x3 -> 1x1, expansion 4), with the
    stride on the 3x3 conv."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = _conv(cin, features, 1, device=device)
        self.bn1 = FrozenBatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, stride, device=device)
        self.bn2 = FrozenBatchNorm(features, device=device)
        self.conv3 = _conv(features, features * 4, 1, device=device)
        self.bn3 = FrozenBatchNorm(features * 4, device=device)
        self.downsample = nn.Sequential(
            _conv(cin, features * 4, 1, stride, device=device),
            FrozenBatchNorm(features * 4, device=device)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-50/101 trunk (7x7/2 stem) returning {layer1..layer4} NCHW maps."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                               device=device)
        self.bn1 = FrozenBatchNorm(64, device=device)
        cin, features = 64, 64
        for i, num_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(num_blocks):
                blocks.append(Bottleneck(
                    cin, features, stride=(1 if i == 0 or j > 0 else 2),
                    downsample=(j == 0), device=device))
                cin = features * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            features *= 2
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            feats[f"layer{i + 1}"] = x
        return feats


class Backbone(nn.Module):
    """ResNet trunk under the name ``body``, returning [(feature NHWC,
    mask (B, h, w)), ...] for the requested layers. The padding mask is
    nearest-resized to each feature map (``jax.image.resize`` "nearest"
    samples at half-pixel centres, which is torch's "nearest-exact")."""

    def __init__(self, return_layers: Sequence[str] = ("layer4",),
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), device=None):
        super().__init__()
        self.return_layers = tuple(return_layers)
        self.body = ResNet(stage_sizes, device=device)

    def forward(self, images: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """images: (B, H, W, 3). mask: (B, H, W), 1 = padded."""
        feats = self.body(images.permute(0, 3, 1, 2))   # channels_last strides
        if mask is None:
            mask = images.new_zeros(images.shape[:3], dtype=torch.float32)
        mask = mask.float()[:, None]
        out = []
        for layer in self.return_layers:
            f = feats[layer]
            m = F.interpolate(mask, size=f.shape[-2:], mode="nearest-exact")
            out.append((f.permute(0, 2, 3, 1), m[:, 0]))
        return out
