"""Train and eval steps (counterpart of ``aloception_tpu/train/step.py``).

One train step is the forward in train mode (dropout on), the criterion in
float32, the backward and the optimizer's step. Its scalar metrics come back
as ONE device tensor in sorted key order, so that a caller reads them with a
single host transfer, the step's only synchronisation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.detr.criterion import detr_criterion
from .state import TrainOptimizer


def to_float32(tree):
    """Floating tensors of a nested dict/list of model outputs in float32:
    the criterion always computes in float32 (bf16 rounding of the log
    softmax and L1 starves the matching gradient)."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_float32(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def pack_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Tuple[List[str], torch.Tensor]:
    """(sorted keys, one float32 tensor of their values)."""
    keys = sorted(metrics)
    return keys, torch.stack([metrics[k].detach().float().reshape(())
                              for k in keys])


def make_train_step(model: nn.Module, optimizer: TrainOptimizer,
                    criterion: Callable,
                    forward_kwargs: Optional[Dict] = None,
                    after_backward: Optional[Callable] = None) -> Callable:
    """``step(inputs, targets)`` -> (sorted metric keys, packed metrics),
    including ``grad_norm``: the forward is ``model(*inputs,
    **forward_kwargs)``, whatever the model's inputs are (images and mask
    for the detectors, two frames for RAFT). ``after_backward()`` runs
    between the backward and the optimizer's step (the Trainer's gradient
    sync)."""
    kwargs = dict(forward_kwargs or {})

    def step(inputs: Sequence[torch.Tensor], targets: Dict
             ) -> Tuple[List[str], torch.Tensor]:
        model.train()
        out = to_float32(model(*inputs, **kwargs))
        loss, metrics = criterion(out, targets)
        optimizer.backward(loss)
        if after_backward is not None:
            after_backward()
        metrics["grad_norm"] = optimizer.step()
        return pack_metrics(metrics)

    return step


def make_detr_train_step(model: nn.Module, optimizer: TrainOptimizer,
                         criterion: Callable = detr_criterion) -> Callable:
    """``step(images, mask, targets)`` -> (sorted metric keys, packed
    metrics), including ``grad_norm``."""
    step = make_train_step(model, optimizer, criterion)

    def detr_step(images: torch.Tensor, mask: torch.Tensor, targets: Dict
                  ) -> Tuple[List[str], torch.Tensor]:
        return step((images, mask), targets)

    return detr_step


def make_eval_step(model: nn.Module, criterion: Callable = detr_criterion,
                   forward_kwargs: Optional[Dict] = None) -> Callable:
    """``step(inputs, targets)`` -> (outputs, sorted metric keys, packed
    metrics), ``model(*inputs, **forward_kwargs)`` in eval mode without
    gradients."""
    kwargs = dict(forward_kwargs or {})

    @torch.no_grad()
    def step(inputs: Sequence[torch.Tensor], targets: Dict
             ) -> Tuple[Dict, List[str], torch.Tensor]:
        model.eval()
        out = model(*inputs, **kwargs)
        _, metrics = criterion(to_float32(out), targets)
        return (out, *pack_metrics(metrics))

    return step
