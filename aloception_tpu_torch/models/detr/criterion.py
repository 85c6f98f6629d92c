"""DETR set criterion (counterpart of
``aloception_tpu/models/detr/criterion.py``).

Cross-entropy over num_classes + 1 with ``eos_coef`` down-weighting the
background class, L1 + GIoU box losses on matched pairs, all repeated over
the auxiliary decoder layers. Loss weights: ce 1, L1 5, GIoU 2.

Everything is static-shape: targets are fixed-capacity padded tensors, and
the matched targets are scattered onto the (B, Nq) class map on the device,
so the criterion never synchronises with the host. The caller hands it
float32 outputs (``train/step.py`` casts them).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops import boxes as box_ops
from ...parallel.shard import batch_count
from .matcher import cost_matrix, match_outputs


def _scatter_to_queries(base: torch.Tensor, targets: Dict,
                        matched: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """``base`` (B, Nq, ...) with ``values`` (B, Nt, ...) written at each
    valid target's matched query; invalid targets are dropped (written to a
    spare query that is cut off)."""
    B, Nq = base.shape[:2]
    q_idx = torch.where(targets["valid"], matched, Nq)
    ext = torch.cat([base, base[:, :1]], 1)
    index = q_idx.view(B, -1, *([1] * (base.dim() - 2))).expand_as(values)
    return ext.scatter(1, index, values)[:, :Nq]


def loss_labels(pred_logits: torch.Tensor, targets: Dict,
                matched: torch.Tensor, num_boxes: torch.Tensor,
                eos_coef: float = 0.1, background_class: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted cross-entropy: background queries get weight eos_coef; the
    weights' total is the global batch's under data parallelism."""
    B, Nq, C = pred_logits.shape
    bg = C - 1 if background_class is None else background_class
    target_classes = _scatter_to_queries(
        torch.full((B, Nq), bg, dtype=torch.long, device=pred_logits.device),
        targets, matched, targets["labels"])
    ce = -F.log_softmax(pred_logits, -1).gather(
        -1, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == bg, eos_coef, 1.0)
    return (ce * w).sum() / batch_count(w.sum(), None), target_classes


def loss_boxes(pred_boxes: torch.Tensor, targets: Dict, matched: torch.Tensor,
               num_boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 + GIoU on matched pairs, normalised by num_boxes."""
    valid = targets["valid"]
    safe_q = torch.where(valid, matched, 0)
    src = pred_boxes.gather(1, safe_q[..., None].expand(-1, -1, 4))
    validf = valid.to(pred_boxes.dtype)
    l1 = (src - targets["boxes"]).abs().sum(-1)
    loss_l1 = (l1 * validf).sum() / num_boxes
    giou = box_ops.giou_xyxy_paired(box_ops.xcyc_to_xyxy(src),
                                    box_ops.xcyc_to_xyxy(targets["boxes"]))
    loss_giou = ((1.0 - giou) * validf).sum() / num_boxes
    return loss_l1, loss_giou


def num_boxes_of(targets: Dict) -> torch.Tensor:
    """The count of valid targets, at least 1, as a float32 tensor: under
    data parallelism the global batch's over dp (``batch_count``), as the
    reference's ``get_num_boxes`` all-reduces it."""
    return batch_count(targets["valid"].sum())


def detr_criterion(m_outputs: Dict, targets: Dict,
                   loss_ce_weight: float = 1.0, loss_boxes_weight: float = 5.0,
                   loss_giou_weight: float = 2.0, eos_coef: float = 0.1,
                   aux_loss: bool = True,
                   background_class: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total DETR loss and its metrics (0-d tensors): ``loss_ce``,
    ``loss_bbox``, ``loss_giou`` of the final output and ``_{i}`` of each
    auxiliary one, ``cardinality_error`` and ``loss_total``. The final and
    auxiliary outputs are matched in one Hungarian call."""
    num_boxes = num_boxes_of(targets)
    outputs = [m_outputs]
    if aux_loss and "aux_outputs" in m_outputs:
        outputs += list(m_outputs["aux_outputs"])
    matched_all = match_outputs(outputs, targets, cost_matrix)

    total, metrics = 0.0, {}
    for i, (out, matched) in enumerate(zip(outputs, matched_all)):
        l_ce, _ = loss_labels(out["pred_logits"], targets, matched, num_boxes,
                              eos_coef, background_class)
        l_l1, l_giou = loss_boxes(out["pred_boxes"], targets, matched,
                                  num_boxes)
        total = total + (loss_ce_weight * l_ce + loss_boxes_weight * l_l1
                         + loss_giou_weight * l_giou)
        suffix = "" if i == 0 else f"_{i - 1}"
        metrics.update({f"loss_ce{suffix}": l_ce, f"loss_bbox{suffix}": l_l1,
                        f"loss_giou{suffix}": l_giou})
    # cardinality error diagnostic
    logits = m_outputs["pred_logits"]
    bg = logits.shape[-1] - 1 if background_class is None else background_class
    n_pred = (logits.argmax(-1) != bg).sum(-1).float()
    metrics["cardinality_error"] = (
        n_pred - targets["valid"].sum(-1).float()).abs().mean().detach()
    metrics["loss_total"] = total
    return total, metrics


def targets_from_frames(frames, max_targets: int = 100) -> Dict:
    """Batched ``Frame`` -> fixed-capacity padded target tensors on the CPU:
    {"boxes" (B, max_targets, 4) float32 relative xcyc, "labels" (B,
    max_targets) int64, "valid" (B, max_targets) bool}."""
    boxes_list = frames.boxes2d if isinstance(frames.boxes2d, list) \
        else [frames.boxes2d]
    B = len(boxes_list)
    boxes = torch.zeros((B, max_targets, 4), dtype=torch.float32)
    labels = torch.zeros((B, max_targets), dtype=torch.long)
    valid = torch.zeros((B, max_targets), dtype=torch.bool)
    for b, bx in enumerate(boxes_list):
        n = min(bx.shape[0], max_targets)
        if n == 0:
            continue
        rel = bx.rel_pos().xcyc() if bx.absolute else bx.xcyc()
        boxes[b, :n] = rel.as_array().detach().float().cpu()[:n]
        lab = rel.get_child("labels")
        if lab is not None and not isinstance(lab, dict):
            labels[b, :n] = lab.as_array().detach().cpu()[:n].long()
        valid[b, :n] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}
