"""Panoptic Quality (counterpart of ``aloception_tpu/metrics/pq_metrics.py``,
the port's own copy).

PQ = sum(IoU of TP) / (TP + FP/2 + FN/2), split into things and stuff.
Samples arrive as (pred ``Mask`` with ``Labels``, gt ``Mask`` with
``Labels``), on any device. Matching is instance-level: each mask channel is
one segment of the argmax instance-id map, same-class pairs match at IoU >
0.5, and an unmatched prediction lying mostly on void ground truth is not a
false positive (panopticapi's rule).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ap_metrics import host

VOID = -1


class PQStatCat:
    """IoU sum and TP/FP/FN counts of one category."""

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def __iadd__(self, o):
        self.iou += o.iou
        self.tp += o.tp
        self.fp += o.fp
        self.fn += o.fn
        return self


class PQMetrics:

    def __init__(self, iou_threshold: float = 0.5):
        self.iou_threshold = iou_threshold
        self.pq_per_cat: Dict[int, PQStatCat] = {}
        self.isthing: Dict[int, bool] = {}
        self.class_names: Optional[list] = None

    def __getitem__(self, label_id: int) -> PQStatCat:
        return self.pq_per_cat.setdefault(label_id, PQStatCat())

    @staticmethod
    def _segments(mask):
        """(N, H, W) channel stack -> ((H, W) instance-id map with VOID
        where no channel covers the pixel, per-channel class ids). Each
        channel is one segment, as in panopticapi's id maps. The id map is
        made where the mask lies; only it goes to the host."""
        arr = mask.array if hasattr(mask, "array") \
            else torch.as_tensor(np.asarray(mask))
        if arr.shape[0] == 0:
            return (np.full(arr.shape[-2:], VOID, np.int32),
                    np.zeros(0, np.int32))
        top, inst = arr.max(0)          # the first channel of largest value
        inst = host(torch.where(top > 0.5, inst, VOID)).astype(np.int32)
        labels = mask.get_child("labels") if hasattr(mask, "get_child") \
            else None
        if labels is not None and not isinstance(labels, dict):
            cats = host(labels.array).astype(np.int32)
        else:
            cats = np.zeros(arr.shape[0], np.int32)
        return inst, cats

    def add_sample(self, p_mask, t_mask,
                   isthing: Optional[Dict[int, bool]] = None):
        """p_mask / t_mask: aloscene.Mask (N, H, W) with Labels.

        Instance-level matching with panopticapi's semantics: each mask
        channel is one segment of the argmax instance-id map, so a channel
        fully occluded by later channels has zero id-map area and drops out
        (it is not an FP: id maps cannot overlap). Same-class pairs
        match at IoU > threshold, one-to-one; at the standard 0.5 threshold
        id-map matches are unique mathematically, the explicit guard covers
        lower thresholds. Unmatched preds are FP unless more than half
        their area lies on VOID ground truth; unmatched gts are FN."""
        p_inst, p_cats = self._segments(p_mask)
        t_inst, t_cats = self._segments(t_mask)

        t_labels = t_mask.get_child("labels")
        if self.class_names is None and t_labels is not None:
            self.class_names = t_labels.labels_names
        if isthing:
            self.isthing.update(isthing)

        p_ids, p_counts = np.unique(p_inst[p_inst != VOID],
                                    return_counts=True)
        t_ids, t_counts = np.unique(t_inst[t_inst != VOID],
                                    return_counts=True)
        p_area = dict(zip(p_ids.tolist(), p_counts.tolist()))
        t_area = dict(zip(t_ids.tolist(), t_counts.tolist()))

        # pairwise intersections in one pass over the pixel grid
        both = (p_inst != VOID) & (t_inst != VOID)
        K = int(t_inst.max()) + 2
        keys, inters = np.unique(
            p_inst[both].astype(np.int64) * K + t_inst[both],
            return_counts=True)

        matched_p, matched_t = set(), set()
        for key, inter in zip(keys.tolist(), inters.tolist()):
            i, j = key // K, key % K
            if p_cats[i] != t_cats[j] or i in matched_p or j in matched_t:
                continue
            union = p_area[i] + t_area[j] - inter
            iou = inter / union if union else 0.0
            if iou > self.iou_threshold:
                c = int(p_cats[i])
                self[c].tp += 1
                self[c].iou += iou
                matched_p.add(i)
                matched_t.add(j)

        void = t_inst == VOID
        for i in p_ids.tolist():
            if i in matched_p:
                continue
            # panopticapi void rule: mostly-void predictions are not FP
            void_overlap = int(np.count_nonzero((p_inst == i) & void))
            if void_overlap <= 0.5 * p_area[i]:
                self[int(p_cats[i])].fp += 1
        for j in t_ids.tolist():
            if j not in matched_t:
                self[int(t_cats[j])].fn += 1

    def pq_average(self, isthing: Optional[bool] = None,
                   print_result: bool = False) -> Dict[str, float]:
        """{pq, sq, rq, n}: means over the categories seen (things only,
        stuff only, or all, by ``isthing``)."""
        pq = sq = rq = n = 0.0
        for label, stat in self.pq_per_cat.items():
            if isthing is not None \
                    and self.isthing.get(label, True) != isthing:
                continue
            if stat.tp + stat.fp + stat.fn == 0:
                continue
            n += 1
            pq_c = stat.iou / (stat.tp + 0.5 * stat.fp + 0.5 * stat.fn)
            sq_c = stat.iou / stat.tp if stat.tp else 0.0
            rq_c = stat.tp / (stat.tp + 0.5 * stat.fp + 0.5 * stat.fn)
            pq += pq_c
            sq += sq_c
            rq += rq_c
        out = {"pq": pq / n if n else 0.0, "sq": sq / n if n else 0.0,
               "rq": rq / n if n else 0.0, "n": n}
        if print_result:
            tag = {None: "all", True: "things", False: "stuff"}[isthing]
            print(f"PQ[{tag}] pq={out['pq']:.3f} sq={out['sq']:.3f} "
                  f"rq={out['rq']:.3f} (n={int(n)})")
        return out
