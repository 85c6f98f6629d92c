"""Deformable-DETR criterion and focal matcher (counterpart of
``aloception_tpu/models/deformable_detr/criterion.py``).

Sigmoid focal classification loss over all queries (no background class:
unmatched queries train toward all-zero logits), the DETR L1/GIoU box
losses; the matcher's class cost uses the focal positive and negative terms.
The final output and the auxiliary decoder layers' are matched in one
Hungarian call (one kernel launch on the card) per criterion call.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...ops import boxes as box_ops
from ..detr.criterion import _scatter_to_queries, loss_boxes, num_boxes_of
from ..detr.matcher import match_outputs


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Element-wise focal binary cross-entropy."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def focal_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                      tgt_valid: torch.Tensor, cost_class: float = 1.0,
                      cost_boxes: float = 5.0, cost_giou: float = 2.0,
                      alpha: float = 0.25, gamma: float = 2.0
                      ) -> torch.Tensor:
    """Deformable-DETR matching costs of a batch, (B, Nq, Nt); columns of
    invalid targets are 0."""
    prob = torch.sigmoid(pred_logits)                       # (B, Nq, C)
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log1p(-prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    B, Nq, _ = prob.shape
    idx = tgt_labels[:, None, :].expand(B, Nq, -1)
    c_class = pos.gather(2, idx) - neg.gather(2, idx)       # (B, Nq, Nt)
    c_l1 = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -box_ops.giou_xyxy(box_ops.xcyc_to_xyxy(pred_boxes),
                                box_ops.xcyc_to_xyxy(tgt_boxes))
    cost = cost_class * c_class + cost_boxes * c_l1 + cost_giou * c_giou
    return torch.where(tgt_valid[:, None, :], cost, 0.0)


def focal_hungarian_match(m_outputs: Dict, targets: Dict, **cost_kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Focal matcher of one model output: (matched query (B, Nt) int64,
    valid (B, Nt) bool); -1 where a target is invalid."""
    matched, = match_outputs([m_outputs], targets, focal_cost_matrix,
                             **cost_kwargs)
    return matched, targets["valid"]


def loss_labels_focal(pred_logits: torch.Tensor, targets: Dict,
                      matched: torch.Tensor, num_boxes: torch.Tensor,
                      alpha: float = 0.25, gamma: float = 2.0
                      ) -> torch.Tensor:
    """Focal classification: matched queries get a one-hot target, all
    others all-zeros; over ``num_boxes`` (``num_boxes_of``: at least 1)."""
    B, Nq, C = pred_logits.shape
    classes = torch.arange(C, device=pred_logits.device)
    onehot = _scatter_to_queries(
        torch.zeros_like(pred_logits), targets, matched,
        (targets["labels"][..., None] == classes).to(pred_logits.dtype))
    loss = sigmoid_focal_loss(pred_logits, onehot, alpha, gamma)
    return loss.mean(1).sum() * Nq / num_boxes / C


def deformable_criterion(m_outputs: Dict, targets: Dict,
                         loss_ce_weight: float = 2.0,
                         loss_boxes_weight: float = 5.0,
                         loss_giou_weight: float = 2.0,
                         alpha: float = 0.25, gamma: float = 2.0,
                         aux_loss: bool = True, **unused
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total Deformable-DETR loss and its metrics (0-d tensors):
    ``loss_ce``, ``loss_bbox``, ``loss_giou`` of the final output and
    ``_{i}`` of each auxiliary one, and ``loss_total``."""
    num_boxes = num_boxes_of(targets)
    outputs = [m_outputs]
    if aux_loss and "aux_outputs" in m_outputs:
        outputs += list(m_outputs["aux_outputs"])
    matched_all = match_outputs(outputs, targets, focal_cost_matrix,
                                alpha=alpha, gamma=gamma)

    total, metrics = 0.0, {}
    for i, (out, matched) in enumerate(zip(outputs, matched_all)):
        l_ce = loss_labels_focal(out["pred_logits"], targets, matched,
                                 num_boxes, alpha, gamma)
        l_l1, l_giou = loss_boxes(out["pred_boxes"], targets, matched,
                                  num_boxes)
        total = total + (loss_ce_weight * l_ce + loss_boxes_weight * l_l1
                         + loss_giou_weight * l_giou)
        suffix = "" if i == 0 else f"_{i - 1}"
        metrics.update({f"loss_ce{suffix}": l_ce, f"loss_bbox{suffix}": l_l1,
                        f"loss_giou{suffix}": l_giou})
    metrics["loss_total"] = total
    return total, metrics
