"""Finetuning variants: a pretrained trunk and a fresh class head
(counterpart of ``aloception_tpu/models/detr/finetune.py``).

``finetune_params`` grafts pretrained weights into a fresh model's
``state_dict``, keeping the fresh values under ``reinit_keys`` (the class
head swap) and wherever the shapes differ.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .detr import Detr, detr_r50


def detr_r50_finetune(num_classes: int, **kwargs) -> Detr:
    """A DETR-R50 with a num_classes + 1 head."""
    return detr_r50(num_classes=num_classes, **kwargs)


def finetune_params(fresh: Dict[str, torch.Tensor],
                    pretrained: Dict[str, torch.Tensor],
                    reinit_keys: Sequence[str] = ("class_embed",)
                    ) -> Dict[str, torch.Tensor]:
    """``fresh`` with every tensor of ``pretrained`` of the same name and
    shape grafted in, except those with a name component in
    ``reinit_keys``."""
    out = {}
    for name, value in fresh.items():
        pre = pretrained.get(name)
        keep_fresh = any(k in name.split(".") for k in reinit_keys)
        out[name] = pre if pre is not None and not keep_fresh \
            and pre.shape == value.shape else value
    return out
