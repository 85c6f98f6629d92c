"""Depth evaluation metrics (counterpart of
``aloception_tpu/metrics/depth_metrics.py``): RMSE, RMSE(log), abs-rel,
sq-rel and the delta-threshold accuracies.

Each sample is computed in float64 on the payload's device, as the JAX
package computes in float64 on the host, and reaches the host in one fetch
of its 7 metrics and valid-pixel count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

KEYS = ("a1", "a2", "a3", "rmse", "rmse_log", "abs_rel", "sq_rel")


def _payload(x) -> torch.Tensor:
    return x.array if hasattr(x, "array") else torch.as_tensor(x)


class DepthMetrics:

    def __init__(self, min_depth: float = 1e-3, max_depth: float = 80.0):
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._sums: Dict[str, float] = {}
        self._n = 0

    def add_sample(self, p_depth, t_depth, mask=None):
        """p_depth / t_depth: Depth or tensors of the same size; ``mask``:
        pixels > 0.5 are kept. A sample without a valid pixel is skipped."""
        p = _payload(p_depth).detach().double().reshape(-1)
        t = _payload(t_depth).detach().double().reshape(-1)
        valid = (t > self.min_depth) & (t < self.max_depth) \
            & torch.isfinite(p) & torch.isfinite(t)
        if mask is not None:
            valid &= _payload(mask).to(p.device).reshape(-1) > 0.5
        n = valid.sum()
        p = p.clamp(self.min_depth, self.max_depth)
        t = torch.where(valid, t, torch.ones_like(t))

        def mean(x):
            return torch.where(valid, x, torch.zeros_like(x)).sum() / n

        thresh = torch.maximum(t / p, p / t)
        values = torch.stack([
            mean((thresh < 1.25).double()),
            mean((thresh < 1.25 ** 2).double()),
            mean((thresh < 1.25 ** 3).double()),
            torch.sqrt(mean((t - p) ** 2)),
            torch.sqrt(mean((torch.log(t) - torch.log(p)) ** 2)),
            mean((t - p).abs() / t),
            mean((t - p) ** 2 / t),
            n.double()]).cpu().tolist()
        if values[-1] == 0:
            return
        for k, v in zip(KEYS, values):
            self._sums[k] = self._sums.get(k, 0.0) + v
        self._n += 1

    def __len__(self):
        return self._n

    def calc_map(self, print_result: bool = False) -> Dict[str, float]:
        """Each metric's mean over the samples."""
        out = {k: v / max(self._n, 1) for k, v in self._sums.items()}
        if print_result:
            print(" | ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out
