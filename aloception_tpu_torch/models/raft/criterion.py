"""RAFT sequence loss and EPE metrics (counterpart of
``aloception_tpu/models/raft/criterion.py``), NCHW.

loss = sum_i gamma^(n - i - 1) * mean |flow_i - gt| over every element of
(B, 2, H, W), invalid pixels zeroed (not a mean over the valid pixels: on
sparse ground truth the two differ severalfold, and the reference's learning
rates assume this one). A pixel is valid where |gt| < max_flow and
``valid`` is 1. EPE and the 1/3/5 px accuracies of the last flow average
over the valid pixels (of the global batch under data parallelism:
``batch_count``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ...parallel.shard import batch_count


def raft_sequence_loss(flow_preds: Sequence[torch.Tensor],
                       flow_gt: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       gamma: float = 0.8, max_flow: float = 400.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: each step's (B, 2, H, W); flow_gt (B, 2, H, W); valid
    (B, H, W), 1 = supervised. Returns (loss, metrics: loss_total, epe, 1px,
    3px, 5px), 0-d float32 tensors."""
    n = len(flow_preds)
    mag = flow_gt.pow(2).sum(1).sqrt()
    v = (mag < max_flow).float()
    if valid is not None:
        v = v * valid.float()
    denom = batch_count(v.sum())
    v = v[:, None]

    loss = 0.0
    for i, pred in enumerate(flow_preds):
        loss = loss + gamma ** (n - i - 1) * ((pred - flow_gt).abs() * v).mean()

    epe_map = (flow_preds[-1] - flow_gt).pow(2).sum(1, keepdim=True).sqrt()
    epe_map = epe_map.detach()
    metrics = {"loss_total": loss, "epe": (epe_map * v).sum() / denom}
    for px in (1, 3, 5):
        metrics[f"{px}px"] = ((epe_map < px).float() * v).sum() / denom
    return loss, metrics
