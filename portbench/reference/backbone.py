"""ResNet-50 with frozen BatchNorm, as published DETR and Deformable-DETR
take it from torchvision (v1.5: the stride on the 3x3 convolution), in
plain float32. Parameter names are torchvision's under the detectors'
``backbone.0.body.`` prefix."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch.nn.functional as F

from .nn import conv2d, frozen_bn

PREFIX = "backbone.0.body"


def _bn_specs(name, c):
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.running_mean", (c,), "zeros"),
            (f"{name}.running_var", (c,), "ones")]


def param_specs(stage_sizes: Sequence[int]) -> List:
    """(name, shape, init) of every weight and frozen statistic."""
    p = PREFIX
    specs = [(f"{p}.conv1.weight", (64, 3, 7, 7), "lecun")]
    specs += _bn_specs(f"{p}.bn1", 64)
    cin, width = 64, 64
    for i, n in enumerate(stage_sizes):
        for j in range(n):
            b = f"{p}.layer{i + 1}.{j}"
            specs += [(f"{b}.conv1.weight", (width, cin, 1, 1), "lecun")]
            specs += _bn_specs(f"{b}.bn1", width)
            specs += [(f"{b}.conv2.weight", (width, width, 3, 3), "lecun")]
            specs += _bn_specs(f"{b}.bn2", width)
            specs += [(f"{b}.conv3.weight", (width * 4, width, 1, 1),
                       "lecun")]
            specs += _bn_specs(f"{b}.bn3", width * 4)
            if j == 0:
                specs += [(f"{b}.downsample.0.weight",
                           (width * 4, cin, 1, 1), "lecun")]
                specs += _bn_specs(f"{b}.downsample.1", width * 4)
            cin = width * 4
        width *= 2
    return specs


def resnet(images, p, cfg, P) -> Dict[str, object]:
    """images (B, H, W, 3) normalised -> {"layer1".."layer4": NCHW maps}."""
    eps = cfg["frozen_bn_eps"]
    x = images.permute(0, 3, 1, 2)
    x = conv2d(x, p, f"{PREFIX}.conv1", P, stride=2, padding=3)
    x = F.relu(frozen_bn(x, p, f"{PREFIX}.bn1", eps))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for i, n in enumerate(cfg["stage_sizes"]):
        for j in range(n):
            b = f"{PREFIX}.layer{i + 1}.{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(frozen_bn(conv2d(x, p, f"{b}.conv1", P), p,
                                 f"{b}.bn1", eps))
            y = F.relu(frozen_bn(conv2d(y, p, f"{b}.conv2", P, stride=stride,
                                        padding=1), p, f"{b}.bn2", eps))
            y = frozen_bn(conv2d(y, p, f"{b}.conv3", P), p, f"{b}.bn3", eps)
            if j == 0:
                x = frozen_bn(conv2d(x, p, f"{b}.downsample.0", P,
                                     stride=stride), p,
                              f"{b}.downsample.1", eps)
            x = F.relu(y + x)
        out[f"layer{i + 1}"] = x
    return out


def is_frozen(name: str) -> bool:
    """A frozen BatchNorm's weight, bias or statistic: fixed, no gradient."""
    parts = name.split(".")
    return name.startswith(PREFIX) and (
        any(s.startswith("bn") for s in parts) or ".downsample.1." in name)
