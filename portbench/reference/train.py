"""Reference training steps in plain float32: forward, the set criterion,
backward, clipping by the global gradient norm and AdamW (decoupled weight
decay) in two groups, the backbone's at its own learning rate, written out
by hand. Frozen BatchNorm statistics take no gradient."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import backbone
from .criterion import deformable_loss


def adamw_(p, g, m, v, step, lr, wd, betas=(0.9, 0.999), eps=1e-8):
    """One AdamW update of ``p`` in place (torch's ``AdamW`` arithmetic)."""
    b1, b2 = betas
    p.mul_(1 - lr * wd)
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_steps(weights: Dict[str, torch.Tensor], batches: List, arch, cfg,
                P, loss_fn=deformable_loss) -> Dict:
    """``len(batches)`` steps from ``weights`` (float32, not changed) on
    batches of (images, mask, targets). Returns the losses, each trainable
    leaf's gradient norm at the first step before and after clipping, and
    its change over all the steps."""
    t = cfg["train"]
    params = {k: v.detach().clone() for k, v in weights.items()}
    leaves = [k for k in params if not backbone.is_frozen(k)]
    for k in leaves:
        params[k].requires_grad_(True)
    state = {k: (torch.zeros_like(params[k]), torch.zeros_like(params[k]))
             for k in leaves}
    losses, raw, clipped = [], {}, {}
    for step, (images, mask, targets) in enumerate(batches, start=1):
        with P.matmuls():
            out = arch.forward(params, images, mask, cfg, P)
            loss = loss_fn(out, targets, t)
            grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        losses.append(float(loss.detach()))
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = 1.0 if norm < t["clip_max_norm"] \
            else t["clip_max_norm"] / norm
        grads = [g * scale for g in grads]
        if step == 1:
            raw = {k: float(torch.linalg.vector_norm(g) / scale)
                   for k, g in zip(leaves, grads)}
            clipped = {k: float(torch.linalg.vector_norm(g))
                       for k, g in zip(leaves, grads)}
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                lr = t["lr_backbone"] if "backbone" in k.split(".") \
                    else t["lr"]
                adamw_(params[k], g, *state[k], step, lr, t["weight_decay"])
        del out, loss, grads
    change = {k: float(torch.linalg.vector_norm(
        params[k].detach() - weights[k])) for k in leaves}
    return {"losses": losses, "raw_grad": raw, "grad": clipped,
            "change": change}
