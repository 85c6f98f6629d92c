"""Per-model trainer factories (counterpart of the DETR and Deformable-DETR
factories of ``aloception_tpu/train/trainers.py``): model, criterion, data
module wired into the generic Trainer with the reference's
default hyperparameters. The RAFT and panoptic trainers wait in ROADMAP A7
and A8.
"""

from __future__ import annotations

from typing import Optional

from ..models.deformable_detr import deformable_detr_r50
from ..models.deformable_detr.criterion import deformable_criterion
from ..models.detr import detr_r50
from ..models.detr.criterion import detr_criterion
from .data_modules import CocoDetection2Detr
from .trainer import Trainer


def make_detr_trainer(data_module: Optional[CocoDetection2Detr] = None,
                      model=None, device=None, **trainer_kwargs) -> Trainer:
    """DETR: lr 1e-4, backbone 1e-5, weight decay 1e-4, clip 0.1,
    accumulate 4. Without ``model``, a float32 DETR-R50 on ``device`` (the
    card unless another is named) with a class per label of the data."""
    dm = data_module or CocoDetection2Detr(sample=True)
    if model is None:
        model = detr_r50(num_classes=len(dm.label_names), device=device)
    # the padded target capacity can never exceed the query count
    dm.max_targets = min(dm.max_targets, model.num_queries)
    trainer_kwargs.setdefault("accumulate_grad_batches", 4)
    trainer_kwargs.setdefault("project", "detr")
    trainer = Trainer(
        model=model,
        criterion=detr_criterion,
        prepare_batch=dm.prepare_batch,
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer


def make_deformable_detr_trainer(with_box_refine: bool = True,
                                 data_module=None, model=None, device=None,
                                 **trainer_kwargs) -> Trainer:
    """Deformable-DETR: lr 2e-4, backbone 2e-5 (the deformable paper's
    configuration), weight decay 1e-4, clip 0.1. Without ``model``, a
    float32 Deformable-DETR-R50 on ``device`` with a class per label of the
    data."""
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
        model=model,
        criterion=deformable_criterion,
        prepare_batch=dm.prepare_batch,
        **trainer_kwargs)
    trainer.data_module = dm
    return trainer
