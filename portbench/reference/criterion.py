"""The Deformable-DETR set criterion in plain float32: every decoder
layer's output matched to the targets by a minimum-cost assignment
(``assignment.assign``, on the host) under the focal class cost, L1 and
GIoU; sigmoid focal classification over every query and class, L1 and GIoU
on the matched pairs, each over the count of targets. The settings are the
configuration's ``train`` group (aloception's: the class cost weighs 1,
the focal term is averaged over the classes as well)."""

from __future__ import annotations

from typing import Dict, List

import torch

from .assignment import assign


def xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def giou(a, b):
    """Generalized IoU of matching boxes (xyxy), broadcast."""
    lt = torch.max(a[..., :2], b[..., :2])
    rb = torch.min(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = _area(a) + _area(b) - inter
    iou = inter / union
    lt = torch.min(a[..., :2], b[..., :2])
    rb = torch.max(a[..., 2:], b[..., 2:])
    hull = (rb - lt).clamp(min=0).prod(-1)
    return iou - (hull - union) / hull


def focal(logits, targets, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    return (alpha * targets + (1 - alpha) * (1 - targets)) * loss


@torch.no_grad()
def match(out, tgt, t) -> List[torch.Tensor]:
    """Per image, the query matched to each of its valid targets."""
    a, g = t["focal_alpha"], t["focal_gamma"]
    prob = torch.sigmoid(out["pred_logits"].float())
    neg = (1 - a) * prob ** g * -torch.log(1 - prob + 1e-8)
    pos = a * (1 - prob) ** g * -torch.log(prob + 1e-8)
    cost_cls = (pos - neg).gather(
        2, tgt["labels"][:, None, :].expand(-1, prob.shape[1], -1))
    boxes = out["pred_boxes"].float()
    cost_l1 = (boxes[:, :, None] - tgt["boxes"][:, None]).abs().sum(-1)
    cost_giou = -giou(xyxy(boxes)[:, :, None], xyxy(tgt["boxes"])[:, None])
    cost = (t["cost_class"] * cost_cls + t["cost_bbox"] * cost_l1
            + t["cost_giou"] * cost_giou).cpu().double().numpy()
    counts = tgt["valid"].sum(-1).tolist()
    dev = boxes.device
    return [torch.as_tensor(assign(cost[b, :, :n].T), device=dev)
            for b, n in enumerate(counts)]


def deformable_loss(outputs: Dict, tgt: Dict, t) -> torch.Tensor:
    """Total loss of the final output and the auxiliary ones."""
    n_boxes = tgt["valid"].sum().float().clamp(min=1)
    total = 0.0
    for out in [outputs] + list(outputs["aux_outputs"]):
        matched = match(out, tgt, t)
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        B, Nq, C = logits.shape
        onehot = torch.zeros_like(logits)
        src, dst = [], []
        for b, q in enumerate(matched):
            n = len(q)
            onehot[b, q, tgt["labels"][b, :n]] = 1.0
            src.append(boxes[b, q])
            dst.append(tgt["boxes"][b, :n])
        ce = focal(logits, onehot, t["focal_alpha"], t["focal_gamma"])
        l_ce = ce.mean(1).sum() * Nq / n_boxes / C
        src, dst = torch.cat(src), torch.cat(dst)
        l1 = (src - dst).abs().sum() / n_boxes
        l_giou = (1 - giou(xyxy(src), xyxy(dst))).sum() / n_boxes
        total = total + (t["loss_ce"] * l_ce + t["loss_bbox"] * l1
                         + t["loss_giou"] * l_giou)
    return total
