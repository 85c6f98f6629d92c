"""Box geometry ops on tensors (counterpart of
``aloception_tpu/ops/boxes.py``).

Formats: ``xcyc`` (xc, yc, w, h) | ``xyxy`` (x1, y1, x2, y2) | ``yxyx``.
"""

from __future__ import annotations

from typing import Tuple

import torch

FORMATS = ("xcyc", "xyxy", "yxyx")


def xcyc_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], -1)


def xyxy_to_xcyc(b: torch.Tensor) -> torch.Tensor:
    lo, hi = b[..., :2], b[..., 2:4]
    return torch.cat([lo + (hi - lo) / 2, hi - lo], -1)


def xyxy_to_yxyx(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2].flip(-1), b[..., 2:4].flip(-1)], -1)


yxyx_to_xyxy = xyxy_to_yxyx  # involution


def xcyc_to_yxyx(b: torch.Tensor) -> torch.Tensor:
    return xyxy_to_yxyx(xcyc_to_xyxy(b))


def yxyx_to_xcyc(b: torch.Tensor) -> torch.Tensor:
    return xyxy_to_xcyc(yxyx_to_xyxy(b))


_CONVERT = {
    ("xcyc", "xyxy"): xcyc_to_xyxy,
    ("xyxy", "xcyc"): xyxy_to_xcyc,
    ("xyxy", "yxyx"): xyxy_to_yxyx,
    ("yxyx", "xyxy"): yxyx_to_xyxy,
    ("xcyc", "yxyx"): xcyc_to_yxyx,
    ("yxyx", "xcyc"): yxyx_to_xcyc,
}


def convert_format(b: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    if src == dst:
        return b
    return _CONVERT[(src, dst)](b)


def area_xyxy(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def iou_xyxy(boxes1: torch.Tensor, boxes2: torch.Tensor,
             ret_union: bool = False, eps: float = 0.0):
    """Pairwise IoU of two xyxy sets: (N, 4), (M, 4) -> (N, M)."""
    area1 = area_xyxy(boxes1)
    area2 = area_xyxy(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / (union + eps)
    if ret_union:
        return iou, union
    return iou


def giou_xyxy(boxes1: torch.Tensor, boxes2: torch.Tensor,
              eps: float = 0.0) -> torch.Tensor:
    """Pairwise generalized IoU (https://giou.stanford.edu/)."""
    iou, union = iou_xyxy(boxes1, boxes2, ret_union=True, eps=eps)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / (area + eps)


def giou_xyxy_paired(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-9) -> torch.Tensor:
    """Element-wise GIoU of aligned box pairs (..., 4) -> (...)."""
    area1 = area_xyxy(boxes1)
    area2 = area_xyxy(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / (union + eps)
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh_c = (rb_c - lt_c).clamp(min=0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / (area_c + eps)


def nms_xyxy(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. Returns (order, keep): indices sorted by decreasing score
    (stable), and a bool mask over that order of the boxes kept. A box is
    suppressed when a kept box of higher score overlaps it by more than
    ``iou_threshold``. Runs on the boxes' device without host syncs."""
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    overlapped = iou_xyxy(b, b) > iou_threshold
    n = boxes.shape[0]
    # earlier (higher-scored) boxes only
    overlapped &= torch.ones(n, n, dtype=torch.bool,
                             device=boxes.device).tril(-1)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep[i] = ~(overlapped[i] & keep).any()
    return order, keep
