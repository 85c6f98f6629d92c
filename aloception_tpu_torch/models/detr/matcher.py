"""DETR Hungarian matcher on the device (counterpart of
``aloception_tpu/models/detr/matcher.py``).

Cost = cost_class * (-softmax probability of the target class)
     + cost_boxes * L1(cx, cy, w, h) + cost_giou * (-GIoU).

Targets are fixed-capacity padded tensors ({"boxes" (B, Nt, 4) relative
xcyc, "labels" (B, Nt) int64, "valid" (B, Nt) bool}, valid targets first).
The cost matrices of a batch are built in one go as batched tensor
operations, and the matrices of several decoder outputs are solved in one
``hungarian`` call (the CUDA kernel on the card), which reads the counts of
valid targets on the device: matching never synchronises with the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ...ops import boxes as box_ops
from ...ops.hungarian import hungarian


def cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                tgt_valid: torch.Tensor, cost_class: float = 1.0,
                cost_boxes: float = 5.0, cost_giou: float = 2.0
                ) -> torch.Tensor:
    """DETR matching costs of a batch, (B, Nq, Nt), queries x targets;
    columns of invalid targets are 0 (the solver never reaches them)."""
    prob = pred_logits.softmax(-1)
    B, Nq, _ = prob.shape
    c_class = -prob.gather(2, tgt_labels[:, None, :].expand(B, Nq, -1))
    c_l1 = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -box_ops.giou_xyxy(box_ops.xcyc_to_xyxy(pred_boxes),
                                box_ops.xcyc_to_xyxy(tgt_boxes))
    cost = cost_class * c_class + cost_boxes * c_l1 + cost_giou * c_giou
    return torch.where(tgt_valid[:, None, :], cost, 0.0)


@torch.no_grad()
def match_outputs(outputs: Sequence[Dict], targets: Dict,
                  cost_fn: Callable = cost_matrix, **cost_kwargs
                  ) -> List[torch.Tensor]:
    """Match several model outputs (the final one and the auxiliary decoder
    layers') to the same targets in ONE Hungarian call: their cost matrices
    are stacked on the batch axis. Returns, per output, (B, Nt) int64: for
    each valid target the index of its query, -1 for invalid targets."""
    costs = torch.cat([
        cost_fn(out["pred_logits"].float(), out["pred_boxes"].float(),
                targets["labels"], targets["boxes"], targets["valid"],
                **cost_kwargs) for out in outputs])
    n_valid = targets["valid"].sum(-1, dtype=torch.int32)
    matched = hungarian(costs, n_valid.repeat(len(outputs)))
    return list(matched.to(costs.device).long().chunk(len(outputs)))


def hungarian_match(m_outputs: Dict, targets: Dict, cost_class: float = 1.0,
                    cost_boxes: float = 5.0, cost_giou: float = 2.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched matcher of one model output: (matched query (B, Nt) int64,
    valid (B, Nt) bool); -1 where a target is invalid."""
    matched, = match_outputs([m_outputs], targets, cost_matrix,
                             cost_class=cost_class, cost_boxes=cost_boxes,
                             cost_giou=cost_giou)
    return matched, targets["valid"]
