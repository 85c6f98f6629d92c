"""Panoptic criterion: a detector's set criterion plus the DICE and focal
mask losses (counterpart of ``aloception_tpu/models/panoptic/criterion.py``).

The mask losses run on the final decoder layer's matching: the matcher runs
once more on the final outputs (one more Hungarian launch on the card, after
the base criterion's), each valid target's matched query mask is gathered,
and the targets are resized to the masks' stride-4 size by nearest
sampling at half-pixel centres (``jax.image.resize``'s "nearest", which is
PyTorch's "nearest-exact"). Everything is static-shape over the padded
targets, weighted by ``valid``: the criterion never synchronises with the
host. The caller hands it float32 outputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from ..deformable_detr.criterion import sigmoid_focal_loss
from ..detr.criterion import detr_criterion, num_boxes_of
from ..detr.matcher import hungarian_match


def dice_loss(pred_logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, num_boxes: torch.Tensor) -> torch.Tensor:
    """Soft DICE over each flattened mask, 1 added to its numerator and its
    denominator; the sum over valid masks over ``num_boxes``."""
    p = pred_logits.sigmoid().flatten(1)
    t = targets.flatten(1)
    num = 2 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    loss = 1 - (num + 1) / (den + 1)
    return (loss * valid).sum() / num_boxes


def focal_mask_loss(pred_logits: torch.Tensor, targets: torch.Tensor,
                    valid: torch.Tensor, num_boxes: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Pixel-wise sigmoid focal loss on soft targets, the mean over each
    mask's (H, W); the sum over valid masks over ``num_boxes``."""
    loss = sigmoid_focal_loss(pred_logits, targets, alpha, gamma)
    return (loss.mean((-2, -1)) * valid).sum() / num_boxes


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor,
               targets: Dict, matched: torch.Tensor, num_boxes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(DICE, focal) of the matched query masks (B, Nq, Hm, Wm) against
    ``target_masks`` (B, Nt, H, W) resized to (Hm, Wm). An invalid target
    (matched -1) reads query 0 and weighs 0."""
    B, _, Hm, Wm = pred_masks.shape
    valid = targets["valid"]
    safe_q = torch.where(valid, matched, 0)
    src = pred_masks[torch.arange(B, device=pred_masks.device)[:, None],
                     safe_q]                                # (B, Nt, Hm, Wm)
    tm = F.interpolate(target_masks, size=(Hm, Wm), mode="nearest-exact")
    src_f, tm_f = src.flatten(0, 1), tm.flatten(0, 1)
    v_f = valid.to(pred_masks.dtype).flatten()
    return (dice_loss(src_f, tm_f, v_f, num_boxes),
            focal_mask_loss(src_f, tm_f, v_f, num_boxes))


def panoptic_criterion(m_outputs: Dict, targets: Dict,
                       base_criterion: Callable = detr_criterion,
                       matcher: Callable = hungarian_match,
                       loss_dice_weight: float = 1.0,
                       loss_focal_weight: float = 1.0,
                       **base_kwargs) -> Tuple[torch.Tensor, Dict]:
    """The base criterion's total and metrics, plus ``loss_DICE`` and
    ``loss_focal`` of the final layer's matching; ``targets`` also carries
    ``masks`` (B, Nt, H, W) float32, aligned with boxes, labels and valid.
    Two Hungarian calls: the base criterion's (every decoder output) and
    the matcher's (the final one)."""
    total, metrics = base_criterion(m_outputs, targets, **base_kwargs)
    num_boxes = num_boxes_of(targets)
    matched, _ = matcher(m_outputs, targets)
    l_dice, l_focal = loss_masks(m_outputs["pred_masks"], targets["masks"],
                                 targets, matched, num_boxes)
    total = total + loss_dice_weight * l_dice + loss_focal_weight * l_focal
    metrics["loss_DICE"] = l_dice
    metrics["loss_focal"] = l_focal
    metrics["loss_total"] = total
    return total, metrics
