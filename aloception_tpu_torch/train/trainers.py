"""Per-model trainer factories (counterpart of
``aloception_tpu/train/trainers.py``): model, criterion, data module and
inference wired into the generic Trainer with the reference's default
hyperparameters, for DETR, Deformable-DETR, the panoptic head on a frozen
detector and RAFT. Each takes ``dtype``, as the JAX factories do: with
bfloat16 the model computes in bfloat16 over float32 masters
(``TrainOptimizer``), the criterion in float32.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models import deformable_detr as dd
from ..models import detr
from ..models.deformable_detr import deformable_detr_r50
from ..models.deformable_detr.criterion import deformable_criterion
from ..models.detr import detr_r50
from ..models.detr.criterion import detr_criterion
from ..models.panoptic import (DetrPanoptic, inference_with_masks,
                               panoptic_criterion)
from ..models.raft import raft, raft_sequence_loss, raft_small
from .data_modules import CocoDetection2Detr, Data2RAFT
from .state import TrainOptimizer, onecycle_schedule
from .trainer import Trainer


def make_detr_trainer(data_module: Optional[CocoDetection2Detr] = None,
                      model=None, device=None,
                      dtype: torch.dtype = torch.float32,
                      **trainer_kwargs) -> Trainer:
    """DETR: lr 1e-4, backbone 1e-5, weight decay 1e-4, clip 0.1,
    accumulate 4. Without ``model``, a DETR-R50 on ``device`` (the card
    unless another is named) with a class per label of the data, built in
    float32 and cast to ``dtype`` by the optimizer."""
    dm = data_module or CocoDetection2Detr(sample=True)
    if model is None:
        model = detr_r50(num_classes=len(dm.label_names), device=device)
    # the padded target capacity can never exceed the query count
    dm.max_targets = min(dm.max_targets, model.num_queries)
    trainer_kwargs.setdefault("accumulate_grad_batches", 4)
    trainer_kwargs.setdefault("project", "detr")
    trainer = Trainer(
        model=model, dtype=dtype,
        criterion=detr_criterion,
        prepare_batch=dm.prepare_batch,
        inference_fn=partial(detr.inference,
                             background_class=model.num_classes),
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer


def make_deformable_detr_trainer(with_box_refine: bool = True,
                                 data_module=None, model=None, device=None,
                                 dtype: torch.dtype = torch.float32,
                                 **trainer_kwargs) -> Trainer:
    """Deformable-DETR: lr 2e-4, backbone 2e-5 (the deformable paper's
    configuration), weight decay 1e-4, clip 0.1. Without ``model``, a
    Deformable-DETR-R50 on ``device`` with a class per label of the data,
    built in float32 and cast to ``dtype`` by the optimizer."""
    dm = data_module or CocoDetection2Detr(sample=True)
    if model is None:
        model = deformable_detr_r50(num_classes=len(dm.label_names),
                                    with_box_refine=with_box_refine,
                                    device=device)
    dm.max_targets = min(dm.max_targets, model.num_queries)
    trainer_kwargs.setdefault("lr", 2e-4)
    trainer_kwargs.setdefault("lr_backbone", 2e-5)
    trainer_kwargs.setdefault("project", "deformable-detr")
    trainer = Trainer(
        model=model, dtype=dtype,
        criterion=deformable_criterion,
        prepare_batch=dm.prepare_batch,
        inference_fn=partial(dd.inference, activation_fn=getattr(
            model, "activation_fn", "sigmoid")),
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer


def make_panoptic_trainer(num_classes: int = 250, data_module=None,
                          detector=None, freeze_detector: bool = True,
                          criterion=None, device=None,
                          dtype: torch.dtype = torch.float32,
                          **trainer_kwargs) -> Trainer:
    """The panoptic head on a detector built with ``return_intermediate``
    (DETR-R50 on ``device`` when None), which is frozen by default: only
    the head trains. AdamW, lr 1e-4, backbone 1e-5, clip 0.1; the frozen
    detector's parameters (``detr.*``) take no gradient and no update; with
    ``dtype`` bfloat16 head and detector compute in bfloat16, the head over
    float32 masters. ``criterion`` defaults to ``panoptic_criterion`` on the
    DETR criterion; ``inference_fn`` is ``inference_with_masks`` with the
    detector's ``activation_fn`` (DETR's is softmax): softmax with the
    background class at the detector's ``num_classes``, or sigmoid."""
    dm = data_module or CocoDetection2Detr(sample=True, return_masks=True)
    n_cls = len(dm.label_names) if dm.label_names else num_classes
    model = DetrPanoptic(detector, num_classes=n_cls,
                         freeze_detector=freeze_detector, device=device)
    dm.max_targets = min(dm.max_targets, model.detr.num_queries)
    trainer_kwargs.setdefault("project", "panoptic")
    if freeze_detector and "optimizer" not in trainer_kwargs:
        trainer_kwargs["optimizer"] = TrainOptimizer(
            model, lr=trainer_kwargs.get("lr", 1e-4),
            lr_backbone=trainer_kwargs.get("lr_backbone", 1e-5),
            weight_decay=trainer_kwargs.get("weight_decay", 1e-4),
            grad_clip=trainer_kwargs.get("grad_clip", 0.1),
            accumulate_steps=trainer_kwargs.get("accumulate_grad_batches", 1),
            freeze_prefixes=("detr",), dtype=dtype)
    act = getattr(model.detr, "activation_fn", "softmax")
    trainer = Trainer(
        model=model, dtype=dtype,
        criterion=criterion or panoptic_criterion,
        prepare_batch=_make_panoptic_prepare(dm),
        inference_fn=partial(
            inference_with_masks, activation_fn=act,
            background_class=model.detr.num_classes if act == "softmax"
            else None),
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer


def panoptic_masks(frames, batch_size: int, n_targets: int,
                   hw) -> torch.Tensor:
    """(B, Nt, H, W) float32 instance masks from each frame's
    ``segmentation`` child, aligned with the padded boxes, labels and valid
    (zeros past a frame's objects); a mask of another size is resized by
    nearest sampling. Made in pinned memory where there is a card: the
    trainer's copy then reads them in place, and the pinned block is reused
    from batch to batch (a DETR bs8 640-px batch holds 1.3 GB of them)."""
    H, W = hw
    masks = torch.zeros((batch_size, n_targets, H, W), dtype=torch.float32,
                        pin_memory=torch.cuda.is_available())
    seg = frames.get_child("segmentation")
    segs: List = seg if isinstance(seg, list) else [seg] * batch_size
    for b, s in enumerate(segs[:batch_size]):
        if s is None or isinstance(s, dict):
            continue
        m = s.array.float().cpu()[:n_targets]
        if len(m) and tuple(m.shape[-2:]) != (H, W):
            m = F.interpolate(m[None], size=(H, W), mode="nearest")[0]
        masks[b, :len(m)] = m
    return masks


def _make_panoptic_prepare(dm: CocoDetection2Detr):
    """The data module's DETR batch with ``targets["masks"]`` added."""

    def prepare(frames_list: List, training: bool = True) -> Dict:
        out = dm.prepare_batch(frames_list, training=training)
        images = out["inputs"][0]
        out["targets"]["masks"] = panoptic_masks(
            out["frames"], images.shape[0], out["targets"]["boxes"].shape[1],
            images.shape[1:3])
        return out

    return prepare


def _raft_criterion(flow_preds, targets, gamma: float = 0.8):
    return raft_sequence_loss(flow_preds, targets["flow"],
                              valid=targets.get("valid"), gamma=gamma)


def make_raft_trainer(small: bool = False, iters: int = 12,
                      data_module: Optional[Data2RAFT] = None, model=None,
                      num_steps: Optional[int] = None, device=None,
                      dtype: torch.dtype = torch.float32,
                      **trainer_kwargs) -> Trainer:
    """RAFT (RAFT-small with ``small``; built in float32 on ``device`` when
    ``model`` is None, and cast to ``dtype`` by the optimizer, its norms
    and the cnet's BatchNorm statistics staying float32): AdamW lr 4e-4 on
    every parameter, weight decay
    1e-4, clip 1.0, the sequence loss on every step's flow of ``iters``
    iterations (the forward takes ``iters``: the JAX package's factory
    drops it and always trains 12, ROADMAP §C). With ``num_steps``, the
    OneCycle schedule over num_steps + 100 updates, as the reference."""
    dm = data_module or Data2RAFT(sample=True)
    if model is None:
        model = (raft_small if small else raft)(device=device)
    lr = trainer_kwargs.setdefault("lr", 4e-4)
    trainer_kwargs.setdefault("lr_backbone", lr)
    trainer_kwargs.setdefault("grad_clip", 1.0)
    trainer_kwargs.setdefault("project", "raft")
    if num_steps is not None and "optimizer" not in trainer_kwargs:
        trainer_kwargs["optimizer"] = TrainOptimizer(
            model, lr=lr, lr_backbone=lr,
            weight_decay=trainer_kwargs.get("weight_decay", 1e-4),
            grad_clip=trainer_kwargs["grad_clip"],
            accumulate_steps=trainer_kwargs.get("accumulate_grad_batches", 1),
            schedule=onecycle_schedule(lr, num_steps + 100), dtype=dtype)
    trainer = Trainer(
        model=model, dtype=dtype,
        criterion=trainer_kwargs.pop("criterion", _raft_criterion),
        prepare_batch=dm.prepare_batch,
        forward_kwargs={"iters": iters},
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer
