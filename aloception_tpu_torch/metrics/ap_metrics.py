"""COCO-style mAP (counterpart of ``aloception_tpu/metrics/ap_metrics.py``,
the port's own copy): per-class AP over the 10 IoU thresholds .50:.05:.95,
with AP50/AP70 per class and the box-size breakdown. Host numpy; samples
arrive as the port's ``BoundingBoxes2D`` with ``Labels``, on any device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))
SIZE_RANGES = {"small": (0.0, 0.001), "medium": (0.001, 0.01),
               "large": (0.01, np.inf), "all": (0.0, np.inf)}


def host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class APDataObject:
    """Per (class, threshold) accumulator."""
    def __init__(self):
        self.data_points: List[Tuple[float, bool]] = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool):
        self.data_points.append((score, is_true))

    def add_gt_positives(self, num: int):
        self.num_gt_positives += num

    def is_empty(self) -> bool:
        return len(self.data_points) == 0 and self.num_gt_positives == 0

    def get_ap(self) -> float:
        """101-point interpolated AP."""
        if self.num_gt_positives == 0:
            return 0.0
        pts = sorted(self.data_points, key=lambda x: -x[0])
        precisions, recalls = [], []
        tp = fp = 0
        for score, is_true in pts:
            if is_true:
                tp += 1
            else:
                fp += 1
            precisions.append(tp / (tp + fp))
            recalls.append(tp / self.num_gt_positives)
        for i in range(len(precisions) - 1, 0, -1):
            precisions[i - 1] = max(precisions[i - 1], precisions[i])
        y_range = np.zeros(101)
        recalls = np.asarray(recalls)
        precisions = np.asarray(precisions)
        x_range = np.arange(101) / 100
        idxs = np.searchsorted(recalls, x_range, side="left")
        for bar_idx, pr_idx in enumerate(idxs):
            if pr_idx < len(precisions):
                y_range[bar_idx] = precisions[pr_idx]
        return float(y_range.mean())


class ApMetrics:
    """Accumulate (pred boxes, gt boxes) pairs; report per-class and
    averaged AP at the COCO thresholds, with the size breakdown."""

    def __init__(self, iou_thresholds=IOU_THRESHOLDS,
                 compute_per_size_ap: bool = True):
        self.iou_thresholds = list(iou_thresholds)
        self.compute_per_size_ap = compute_per_size_ap
        self.class_names: Optional[List[str]] = None
        self.ap_data: Optional[Dict] = None

    def init_data_objects(self, class_names: List[str]):
        self.class_names = list(class_names)
        sizes = list(SIZE_RANGES) if self.compute_per_size_ap else ["all"]
        self.ap_data = {
            size: {t: [APDataObject() for _ in class_names]
                   for t in self.iou_thresholds}
            for size in sizes}

    def add_sample(self, p_bbox, t_bbox):
        """p_bbox: predicted BoundingBoxes2D with Labels(scores);
        t_bbox: ground-truth BoundingBoxes2D with Labels."""
        t_labels = t_bbox.get_child("labels")
        p_labels = p_bbox.get_child("labels")
        if self.class_names is None:
            names = t_labels.labels_names if t_labels is not None else None
            if names is None:
                n_cls = int(max(host(t_labels.array).max(initial=0),
                                host(p_labels.array).max(initial=0))) + 1
                names = [str(i) for i in range(n_cls)]
            self.init_data_objects(names)

        p_rel = p_bbox.rel_pos().xyxy()
        t_rel = t_bbox.rel_pos().xyxy()
        p_np = host(p_rel.array).reshape(-1, 4)
        t_np = host(t_rel.array).reshape(-1, 4)
        classes = host(p_labels.array).astype(int) if p_labels is not None \
            else np.zeros(len(p_np), int)
        scores = host(p_labels.scores) if p_labels is not None and \
            p_labels.scores is not None else np.ones(len(p_np))
        gt_classes = host(t_labels.array).astype(int) \
            if t_labels is not None else np.zeros(len(t_np), int)

        # sort predictions by descending score
        order = np.argsort(-scores)
        p_np, classes, scores = p_np[order], classes[order], scores[order]

        iou = _iou_matrix(p_np, t_np)
        t_area = (t_np[:, 2] - t_np[:, 0]) * (t_np[:, 3] - t_np[:, 1])
        p_area = (p_np[:, 2] - p_np[:, 0]) * (p_np[:, 3] - p_np[:, 1])

        for size, (lo, hi) in (SIZE_RANGES.items()
                               if self.compute_per_size_ap
                               else [("all", SIZE_RANGES["all"])]):
            gt_in_size = (t_area >= lo) & (t_area < hi)
            for t in self.iou_thresholds:
                for c in set(classes.tolist()) | set(gt_classes.tolist()):
                    if c >= len(self.class_names) or c < 0:
                        continue
                    gt_mask = (gt_classes == c) & gt_in_size
                    obj = self.ap_data[size][t][c]
                    obj.add_gt_positives(int(gt_mask.sum()))
                    matched = np.zeros(len(t_np), bool)
                    for pi in np.nonzero(classes == c)[0]:
                        if size != "all" and not (lo <= p_area[pi] < hi):
                            continue
                        best_j, best_iou = -1, t
                        for j in np.nonzero(gt_mask)[0]:
                            if not matched[j] and iou[pi, j] > best_iou:
                                best_j, best_iou = j, iou[pi, j]
                        if best_j >= 0:
                            matched[best_j] = True
                            obj.push(float(scores[pi]), True)
                        else:
                            # ignore FPs matching gt outside the size range
                            ignore = False
                            if size != "all":
                                for j in np.nonzero((gt_classes == c)
                                                    & ~gt_in_size)[0]:
                                    if iou[pi, j] > t:
                                        ignore = True
                                        break
                            if not ignore:
                                obj.push(float(scores[pi]), False)

    def calc_map(self, print_result: bool = False):
        """(all_maps {size: {threshold in %: AP, "all": mean}}, per_class
        {name: {"ap50", "ap70"}})."""
        assert self.ap_data is not None, "no samples added"
        all_maps: Dict[str, Dict] = {}
        per_class = {}
        for size in self.ap_data:
            all_maps[size] = {}
            for t in self.iou_thresholds:
                aps = [o.get_ap() for o in self.ap_data[size][t]
                       if not o.is_empty()]
                all_maps[size][int(round(t * 100))] = \
                    100 * float(np.mean(aps)) if aps else 0.0
            all_maps[size]["all"] = float(np.mean(
                list(all_maps[size].values()))) if all_maps[size] else 0.0
        for ci, cname in enumerate(self.class_names):
            o50 = self.ap_data["all"][0.5][ci]
            o70 = self.ap_data["all"][0.7][ci]
            if not o50.is_empty():
                per_class[cname] = {"ap50": 100 * o50.get_ap(),
                                    "ap70": 100 * o70.get_ap()}
        if print_result:
            print_map_table(all_maps, per_class)
        return all_maps, per_class


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def print_map_table(all_maps: Dict, per_class: Dict):
    """The AP tables as text."""
    for size, vals in all_maps.items():
        keys = [k for k in vals if k != "all"]
        header = " | ".join(f"{k:>6}" for k in keys + ["all"])
        row = " | ".join(f"{vals[k]:6.2f}" for k in keys + ["all"])
        print(f"-- {size} --\n{header}\n{row}")
    if per_class:
        print("-- per class (AP50 / AP70) --")
        for c, v in per_class.items():
            print(f"{c:>20}: {v['ap50']:6.2f} / {v['ap70']:6.2f}")
