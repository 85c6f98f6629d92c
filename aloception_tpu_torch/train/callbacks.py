"""Training callbacks (counterpart of ``aloception_tpu/train/callbacks.py``):
``MetricsCallback``, the AP, PQ and EPE callbacks over the port's own
``metrics``, and ``ObjectDetectorCallback``, which logs the views of the
first validation batch's predicted boxes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class Callback:
    def on_train_batch_end(self, trainer, metrics: Dict, step: int): ...
    def on_val_batch_end(self, trainer, outputs, batch, metrics: Dict): ...
    def on_val_epoch_end(self, trainer, step: int): ...
    def on_epoch_end(self, trainer, epoch: int): ...


class MetricsCallback(Callback):
    """EMA-smoothed train scalars, mean val scalars."""

    def __init__(self, log_every: int = 10, smoothing: float = 0.9):
        self.log_every = log_every
        self.smoothing = smoothing
        self._ema: Dict[str, float] = {}
        self._val: Dict[str, List[float]] = defaultdict(list)

    def on_train_batch_end(self, trainer, metrics, step):
        for k, v in metrics.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            self._ema[k] = v if k not in self._ema else \
                self.smoothing * self._ema[k] + (1 - self.smoothing) * v
        if step % self.log_every == 0:
            trainer.logger.log_scalars(self._ema, step, prefix="train/")

    def on_val_batch_end(self, trainer, outputs, batch, metrics):
        for k, v in metrics.items():
            try:
                self._val[k].append(float(v))
            except (TypeError, ValueError):
                pass

    def on_val_epoch_end(self, trainer, step):
        means = {k: float(np.mean(v)) for k, v in self._val.items() if v}
        trainer.logger.log_scalars(means, step, prefix="val/")
        trainer.last_val_metrics = {f"val_{k}": v for k, v in means.items()}
        self._val.clear()


class ApMetricsCallback(Callback):
    """COCO AP over a validation pass: ``trainer.inference_fn(outputs)``
    gives each image's predicted boxes, the batch's ``frames`` their ground
    truth; printed and logged at the end of the pass."""

    def __init__(self):
        from ..metrics import ApMetrics
        self._make = ApMetrics
        self.ap = ApMetrics()

    def on_val_batch_end(self, trainer, outputs, batch, metrics):
        frames = batch.get("frames")
        if frames is None or trainer.inference_fn is None:
            return
        gt = frames.boxes2d if isinstance(frames.boxes2d, list) \
            else [frames.boxes2d]
        for p, t in zip(trainer.inference_fn(outputs), gt):
            if t is not None:
                self.ap.add_sample(p, t)

    def on_val_epoch_end(self, trainer, step):
        if self.ap.ap_data is None:
            return
        all_maps, _ = self.ap.calc_map(print_result=True)
        trainer.logger.log_scalars(
            {f"AP{k}": v for k, v in all_maps["all"].items()}, step,
            prefix="val/")
        self.ap = self._make()


class ObjectDetectorCallback(Callback):
    """The first validation batch's predicted boxes drawn on its frames
    (norm01) and logged with ``log_image`` as ``val/pred_boxes_<b>``, once
    a validation pass (object_detector_callback.py:42-196). The frames and
    the predictions are fetched to the host and drawn there."""

    def __init__(self, max_images: int = 4):
        self.max_images = max_images
        self._logged_this_epoch = False

    def on_val_batch_end(self, trainer, outputs, batch, metrics):
        if self._logged_this_epoch or trainer.inference_fn is None:
            return
        frames = batch.get("frames")
        if frames is None:
            return
        p_boxes = trainer.inference_fn(outputs)
        for b in range(min(self.max_images, len(p_boxes))):
            frame = (frames[b] if frames.has_dim("B") else frames).cpu()
            image = (frame.norm01().as_image(torch.float32) / 255
                     ).clamp(0, 1).numpy()
            view = p_boxes[b].get_view(frame=image, frame_size=frame.HW)
            trainer.logger.log_image(f"val/pred_boxes_{b}", view.image,
                                     trainer.global_step)
        self._logged_this_epoch = True

    def on_val_epoch_end(self, trainer, step):
        self._logged_this_epoch = False


class PQMetricsCallback(Callback):
    """Panoptic quality over a validation pass: ``trainer.inference_fn``
    gives (boxes, masks) pairs, its masks upsampled to the ground-truth
    segmentation's size (``frame_size``); printed and logged for all,
    things and stuff at the end of the pass."""

    def __init__(self, isthing=None):
        from ..metrics import PQMetrics
        self._make = PQMetrics
        self.pq = PQMetrics()
        self.isthing = isthing

    def on_val_batch_end(self, trainer, outputs, batch, metrics):
        frames = batch.get("frames")
        if frames is None or trainer.inference_fn is None:
            return
        seg = frames.get_child("segmentation")
        segs = seg if isinstance(seg, list) else [seg]
        segs = [g if g is not None and not isinstance(g, dict) else None
                for g in segs]
        size = next((tuple(g.shape[-2:]) for g in segs if g is not None),
                    None)
        for (_, masks), gt in zip(trainer.inference_fn(outputs,
                                                       frame_size=size),
                                  segs):
            if gt is not None:
                self.pq.add_sample(masks, gt, isthing=self.isthing)

    def on_val_epoch_end(self, trainer, step):
        for isthing, tag in ((None, "all"), (True, "things"),
                             (False, "stuff")):
            out = self.pq.pq_average(isthing=isthing, print_result=True)
            trainer.logger.log_scalars(
                {f"PQ_{tag}_{k}": v for k, v in out.items()}, step,
                prefix="val/")
        self.pq = self._make()


class EPECallback(Callback):
    """End-point error of a flow model over a validation pass: the mean of
    the criterion's per-batch ``epe``, printed and logged."""

    def __init__(self):
        self._epes: List[float] = []

    def on_val_batch_end(self, trainer, outputs, batch, metrics):
        if "epe" in metrics:
            self._epes.append(float(metrics["epe"]))

    def on_val_epoch_end(self, trainer, step):
        if self._epes:
            epe = float(np.mean(self._epes))
            trainer.logger.log_scalar("val/EPE", epe, step)
            print(f"[EPE] {epe:.4f} over {len(self._epes)} val batches")
            self._epes = []
