"""Training callbacks (counterpart of the ``Callback`` and
``MetricsCallback`` of ``aloception_tpu/train/callbacks.py``).

The AP and PQ callbacks, which need a copy of the metrics package, wait in
ROADMAP A6.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


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
