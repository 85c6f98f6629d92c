"""The numbers that decide ``correct`` for served optical flow: the flow
that reached the host against the plain reference's on the same weights
and frames, over every served pixel."""

from __future__ import annotations

from typing import Dict

import torch

INF = float("inf")


def flow_numbers(ref: torch.Tensor, got: torch.Tensor) -> Dict[str, float]:
    """A served batch of flows (B, 2, H, W) against the reference's:

    - ``epe``: the mean end-point gap (the length of the two flows'
      difference) over every pixel, in pixels;
    - ``flow_max``: the widest gap of a flow component, over the largest
      reference component (at least 1);
    - ``flow_rms``: the root mean square of the gaps over that of the
      reference flow.

    Flows of another shape, or with a NaN, read infinite."""
    names = ("epe", "flow_max", "flow_rms")
    ref = ref.float()
    got = got.to(ref.device).float()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return dict.fromkeys(names, INF)
    gap = got - ref
    return {"epe": float(gap.pow(2).sum(1).sqrt().mean()),
            "flow_max": float(gap.abs().max()
                              / max(1.0, float(ref.abs().max()))),
            "flow_rms": float(gap.pow(2).mean().sqrt()
                              / ref.pow(2).mean().sqrt())}
