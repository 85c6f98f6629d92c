"""RAFT's feature and context encoders (counterpart of
``aloception_tpu/models/raft/extractor.py``), NCHW.

A 7x7/2 conv stem, three stages of two residual (or bottleneck) blocks, the
last two of stride 2, and a 1x1 projection: output at 1/8 resolution.
Module names are the reference ``state_dict``'s (``conv1``, ``norm1``,
``layer1.0.conv1``, ``layer2.0.downsample.0`` ...); a block's downsample norm
is registered both as ``normK`` and as ``downsample.1``, as in the
reference.

Norms, each computed in at least float32 and cast back to its input's dtype
(as flax normalises):

- ``instance``: per sample and channel over H, W, no affine, eps 1e-5;
- ``batch``: BatchNorm2d, eps 1e-5, its running statistics in eval mode;
  in train mode it normalises with the batch's statistics and moves the
  running ones toward them by 0.1 (flax's momentum 0.9) as flax does: the
  variance it keeps is the biased batch variance, where
  ``nn.BatchNorm2d`` keeps the unbiased one; under data parallelism
  (``parallel.use_mesh`` with dp > 1) the statistics are the global
  batch's, from sums over the dp group that carry gradients, as the JAX
  package's one jit over the global batch computes them;
- ``group``: GroupNorm, eps 1e-5: 8 groups in the stem, planes // 8 in the
  blocks, planes // 8 even on the bottleneck's planes // 4 norms;
- ``none``: identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import axis_group, axis_size, current_mesh
from ...parallel.shard import dp_sum


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or wider if it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class InstanceNorm(nn.InstanceNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(_wide(x), eps=self.eps).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _wide(x)
        if not self.training:
            return super().forward(y).to(x.dtype)
        if axis_group(current_mesh(), "dp") is not None:
            return self._global_batch(y).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(y, (0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(y, None, None, self.weight, self.bias,
                            training=True, eps=self.eps).to(x.dtype)

    def _global_batch(self, y: torch.Tensor) -> torch.Tensor:
        """Train mode over the dp group's batch: every rank holds as many
        rows (``shard_batch``)."""
        count = y.numel() // y.shape[1] * axis_size(current_mesh(), "dp")
        mean = dp_sum(y.sum((0, 2, 3))) / count
        centred = y - mean[None, :, None, None]
        var = dp_sum(centred.pow(2).sum((0, 2, 3))) / count
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return centred * scale[None, :, None, None] \
            + self.bias[None, :, None, None]


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_wide(x)).to(x.dtype)


def make_norm(norm_fn: str, channels: int, groups: int,
              device=None) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm(channels)
    if norm_fn == "batch":
        return BatchNorm(channels, eps=1e-5, momentum=0.1, device=device)
    if norm_fn == "group":
        return GroupNorm(groups, channels, eps=1e-5, device=device)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm_fn!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs, ReLU after each norm and after the residual add; the
    shortcut is a 1x1 conv and norm when the stride is not 1."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1, device=None):
        super().__init__()
        g = planes // 8
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                               device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, device=device)
        self.norm1 = make_norm(norm_fn, planes, g, device)
        self.norm2 = make_norm(norm_fn, planes, g, device)
        self.downsample = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes, g, device)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, device=device),
                self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 at planes // 4 width."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1, device=None):
        super().__init__()
        q, g = planes // 4, planes // 8
        self.conv1 = nn.Conv2d(in_planes, q, 1, device=device)
        self.conv2 = nn.Conv2d(q, q, 3, stride=stride, padding=1,
                               device=device)
        self.conv3 = nn.Conv2d(q, planes, 1, device=device)
        self.norm1 = make_norm(norm_fn, q, g, device)
        self.norm2 = make_norm(norm_fn, q, g, device)
        self.norm3 = make_norm(norm_fn, planes, g, device)
        self.downsample = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, planes, g, device)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, device=device),
                self.norm4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """(B, 3, H, W) -> (B, output_dim, H/8, W/8)."""

    block_cls = ResidualBlock
    dims: Sequence[int] = (64, 64, 96, 128)

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 device=None):
        super().__init__()
        d = self.dims
        self.conv1 = nn.Conv2d(3, d[0], 7, stride=2, padding=3, device=device)
        self.norm1 = make_norm(norm_fn, d[0], 8, device)
        for i, (planes, stride) in enumerate(zip(d[1:], (1, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                self.block_cls(d[i], planes, norm_fn, stride, device),
                self.block_cls(planes, planes, norm_fn, 1, device)))
        self.conv2 = nn.Conv2d(d[-1], output_dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class SmallEncoder(BasicEncoder):
    """The bottlenecked encoder of RAFT-small."""

    block_cls = BottleneckBlock
    dims = (32, 32, 64, 96)

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance",
                 device=None):
        super().__init__(output_dim, norm_fn, device)
