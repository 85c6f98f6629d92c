"""3D mAP (counterpart of ``aloception_tpu/metrics/ap_metrics_3d.py``): the
AP machinery of ``ApMetrics`` with matches by 3D IoU. The IoU matrix is
computed on the boxes' device (``BoundingBoxes3D.iou3d_with``) and reaches
the host with the labels and scores in one fetch a sample; the greedy match
is a host loop, as in the JAX package."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .ap_metrics import APDataObject, print_map_table

IOU3D_THRESHOLDS = (0.1, 0.25, 0.5, 0.7)


class ApMetrics3D:

    def __init__(self, iou_thresholds=IOU3D_THRESHOLDS):
        self.iou_thresholds = list(iou_thresholds)
        self.class_names: Optional[List[str]] = None
        self.ap_data: Optional[Dict] = None

    def init_data_objects(self, class_names: List[str]):
        self.class_names = list(class_names)
        self.ap_data = {t: [APDataObject() for _ in class_names]
                        for t in self.iou_thresholds}

    @staticmethod
    def _fetch(p_boxes3d, t_boxes3d):
        """(IoU matrix, predicted classes, scores, target classes) on the
        host, in one copy from the boxes' device."""
        p_labels = p_boxes3d.get_child("labels")
        t_labels = t_boxes3d.get_child("labels")
        n_p, n_t = len(p_labels.array), len(t_labels.array)
        scores = p_labels.scores if p_labels.scores is not None \
            else torch.ones(n_p, device=p_labels.device)
        iou = p_boxes3d.iou3d_with(t_boxes3d) if n_p and n_t \
            else torch.zeros((n_p, n_t), device=p_labels.device)
        packed = torch.cat([iou.reshape(-1).float(), p_labels.array.float(),
                            scores.float(), t_labels.array.float()])
        host = packed.cpu().numpy()
        splits = np.cumsum([n_p * n_t, n_p, n_p])
        iou, classes, scores, gt_classes = np.split(host, splits)
        return (iou.reshape(n_p, n_t), classes.astype(int), scores,
                gt_classes.astype(int))

    def add_sample(self, p_boxes3d, t_boxes3d):
        """p/t: BoundingBoxes3D with Labels (the predictions' with scores)."""
        iou, classes, scores, gt_classes = self._fetch(p_boxes3d, t_boxes3d)
        if self.class_names is None:
            names = t_boxes3d.get_child("labels").labels_names
            if names is None:
                hi = int(max(gt_classes.max(initial=0),
                             classes.max(initial=0))) + 1
                names = [str(i) for i in range(hi)]
            self.init_data_objects(names)

        order = np.argsort(-scores)
        for t in self.iou_thresholds:
            for c in set(classes.tolist()) | set(gt_classes.tolist()):
                if c < 0 or c >= len(self.class_names):
                    continue
                obj = self.ap_data[t][c]
                gt_mask = gt_classes == c
                obj.add_gt_positives(int(gt_mask.sum()))
                matched = np.zeros(len(gt_classes), bool)
                for pi in order:
                    if classes[pi] != c:
                        continue
                    best_j, best = -1, t
                    for j in np.nonzero(gt_mask)[0]:
                        if not matched[j] and iou[pi, j] > best:
                            best_j, best = j, iou[pi, j]
                    if best_j >= 0:
                        matched[best_j] = True
                    obj.push(float(scores[pi]), bool(best_j >= 0))

    def calc_map(self, print_result: bool = False):
        """{"all": {threshold in %: mAP, "all": their mean}}."""
        if self.ap_data is None:
            raise RuntimeError("calc_map before any sample")
        all_maps = {"all": {}}
        for t in self.iou_thresholds:
            aps = [o.get_ap() for o in self.ap_data[t] if not o.is_empty()]
            all_maps["all"][int(round(t * 100))] = \
                100 * float(np.mean(aps)) if aps else 0.0
        all_maps["all"]["all"] = float(np.mean(list(all_maps["all"].values())))
        if print_result:
            print_map_table(all_maps, {})
        return all_maps
