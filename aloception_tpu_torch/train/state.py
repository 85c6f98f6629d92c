"""Optimizer construction (counterpart of ``aloception_tpu/train/state.py``).

The reference DETR training configuration: AdamW, lr 1e-4 on the head and
1e-5 on the backbone, weight decay 1e-4, gradient clipping by global norm at
0.1 and gradient accumulation. The JAX package writes it as an optax chain
(zero frozen-BN gradients, clip by global norm, two masked AdamW groups,
``MultiSteps``, built by ``make_optimizer``); here it is one
``TrainOptimizer`` over a model's named parameters that means the same:

- frozen BatchNorm statistics are buffers of the model, so they have no
  gradient, no optimizer state and no share of the norm; parameters under
  ``freeze_prefixes`` are set to need no gradient and left out likewise;
- the backbone group is every parameter with a ``backbone`` component in its
  name, the head group all others;
- clipping is optax's: ``g * (max / norm)`` where ``norm >= max``, computed
  on the device without a host sync;
- accumulation runs ``k`` backward passes of ``loss / k`` into the
  gradients, then one update of their mean, as ``optax.MultiSteps`` does.

With ``dtype`` bfloat16 it trains as the JAX package's models built with
``dtype=bfloat16`` train: flax keeps float32 parameters and casts them to
bfloat16 where a layer uses them, so the gradient that reaches a parameter
is the bfloat16 gradient of its cast, widened, and optax updates in float32.
Here the optimizer keeps a float32 master of each parameter that the model
holds in bfloat16 (the model is cast by ``models.transformers.
cast_for_training``, norms and what flax keeps in float32 staying float32):
each backward's bfloat16 gradients are widened and accumulated in the
masters' float32 gradients, the norm is taken and clipped and AdamW steps in
float32 on the masters, and the masters are copied back into the model,
rounded. A checkpoint holds the masters under the model's key names
(``model_state_dict``), so that it loads into a float32 model as it is.

Under tensor parallelism or FSDP (``parallel.partition_params``) the
parameters, their gradients and the AdamW moments are DTensors, each
rank's shard; the global norm then sums the shards' squares over the ranks
that split them, and the clipping and the update act on the shards. A
model placed so trains in bfloat16 as the JAX package's does, whose
float32 parameters are placed by the rule: the masters are taken from the
placed float32 parameters before the cast, so that each master is placed
as its parameter is (a tp parameter's master is its tp shard, in float32),
and FSDP's shards, which its mixed-precision policy casts where it gathers
them, stay float32 and are their own masters. AdamW steps shards, not
whole tensors.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.transformers import cast_for_training, set_data_
from ..parallel.shard import copy_full_, fsdp_sharded, place_optimizer_state


def onecycle_schedule(peak_lr: float, total_steps: int,
                      pct_start: float = 0.05, div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch OneCycleLR with anneal_strategy='linear': linear warm-up from
    peak / div_factor to peak over pct_start of the steps, then linear
    anneal to peak / div_factor / final_div_factor, clamped past the end.
    Returns step -> lr."""
    init = peak_lr / div_factor
    final = init / final_div_factor
    warm = max(1, int(total_steps * pct_start))
    down_steps = max(1, total_steps - warm)

    def schedule(step: int) -> float:
        s = float(min(step, total_steps))
        if s < warm:
            return init + (peak_lr - init) * (s / warm)
        return peak_lr + (final - peak_lr) * ((s - warm) / down_steps)

    return schedule


def _components(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor, the tensor itself otherwise."""
    return getattr(t, "_local_tensor", t)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``grads``, a 0-d float32 tensor. A DTensor
    counts its local shard, summed over each mesh dim that shards it (an
    all-reduce per kind of placement); a replicated one counts once."""
    plain = [g for g in grads if not hasattr(g, "_local_tensor")]
    sharded = {}
    for g in grads:
        if hasattr(g, "_local_tensor"):
            dims = tuple(i for i, pl in enumerate(g.placements)
                         if pl.is_shard())
            sharded.setdefault((id(g.device_mesh), dims),
                               (g.device_mesh, dims, []))[2].append(g)
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(plain)]))
    import torch.distributed as dist
    sq = 0.0
    for mesh, dims, gs in sharded.values():
        part = torch.stack([n.float() for n in torch._foreach_norm(
            [g._local_tensor for g in gs])]).pow(2).sum()
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        sq = sq + part
    if plain:
        sq = sq + torch.stack([n.float() for n in torch._foreach_norm(
            plain)]).pow(2).sum()
    return sq.sqrt()


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global norm
    is at least ``max_norm`` (optax's ``clip_by_global_norm``). Returns the
    norm before clipping, a 0-d float32 tensor on the gradients' device. No
    host sync."""
    grads = [g for g in grads if g is not None]
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_([_local(g) for g in grads], scale)
    return norm


class TrainOptimizer:
    """AdamW in two groups, clipping and accumulation over a model's
    parameters. Call ``backward(loss)`` for each batch, then ``step()``;
    every ``accumulate_steps``-th ``step`` updates the parameters."""

    def __init__(self, model: nn.Module, lr: float = 1e-4,
                 lr_backbone: float = 1e-5, weight_decay: float = 1e-4,
                 grad_clip: float = 0.1, accumulate_steps: int = 1,
                 schedule: Optional[Callable[[int], float]] = None,
                 freeze_prefixes: Tuple[str, ...] = (),
                 dtype: torch.dtype = torch.float32):
        """With a ``dtype`` other than float32, the masters are taken from
        the model's parameters as they are (exact when it was built in
        float32; DTensors where they are placed) and the model is then cast
        by ``cast_for_training``, FSDP's shards excepted."""
        # what builds the same optimizer over a model whose parameters
        # were replaced (``parallel.partition_params``)
        self.config = dict(lr=lr, lr_backbone=lr_backbone,
                           weight_decay=weight_decay, grad_clip=grad_clip,
                           accumulate_steps=accumulate_steps,
                           schedule=schedule, freeze_prefixes=freeze_prefixes,
                           dtype=dtype)
        self.lr, self.lr_backbone = lr, lr_backbone
        self.grad_clip = grad_clip
        self.accumulate_steps = max(1, int(accumulate_steps))
        self.schedule = schedule
        head, backbone = [], []
        for name, p in model.named_parameters():
            parts = _components(name)
            if any(f in parts for f in freeze_prefixes):
                p.requires_grad_(False)
            elif not p.requires_grad:
                continue
            elif "backbone" in parts:
                backbone.append((name, p))
            else:
                head.append((name, p))
        masters = {}
        if dtype != torch.float32:
            # FSDP's float32 shards are cast where they are gathered
            sharded = {id(p) for p in model.parameters() if fsdp_sharded(p)}
            masters = {name: p.detach().float().clone()
                       for name, p in model.named_parameters()
                       if id(p) not in sharded}
            cast_for_training(model, dtype, skip=sharded)
        self.params = [p for _, p in head + backbone]
        # (name, parameter, float32 master) of each parameter the model
        # holds in a lower precision; a float32 parameter is its own master
        self.low = [(name, p, masters.get(name, p.detach().float()))
                    for name, p in head + backbone
                    if p.dtype != torch.float32]
        low = {name: m for name, _, m in self.low}
        self.masters = [low.get(name, p) for name, p in head + backbone]
        # the float32 values of the frozen parameters the cast rounded, for
        # the checkpoints: they take no update
        self.frozen = {name: masters[name] for name, p in
                       model.named_parameters() if name in masters
                       and name not in low and p.dtype != torch.float32}
        # FSDP leaves small parameters whole beside its DTensors: the
        # multi-tensor kernels refuse the mix (torch 2.11), one per tensor
        mixed = len({hasattr(m, "_local_tensor") for m in self.masters}) > 1
        self.adamw = torch.optim.AdamW(
            [{"params": self.masters[:len(head)], "lr": lr},
             {"params": self.masters[len(head):], "lr": lr_backbone}],
            lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
            foreach=False if mixed else None)
        self.micro_steps = 0       # backward passes since the last update
        self.updates = 0           # parameter updates applied

    def backward(self, loss: torch.Tensor):
        (loss / self.accumulate_steps).backward()

    def _set_lr(self):
        if self.schedule is None:
            return
        lr = self.schedule(self.updates)
        scale = self.lr_backbone / self.lr if self.lr > 0 else 1.0
        self.adamw.param_groups[0]["lr"] = lr
        self.adamw.param_groups[1]["lr"] = lr * scale

    def step(self) -> torch.Tensor:
        """Count one accumulated batch; on the ``accumulate_steps``-th clip
        the mean gradient and update. Returns the global norm of the mean
        gradient accumulated so far (the norm that is clipped, on an update),
        a 0-d device tensor."""
        self.micro_steps += 1
        # the low-precision gradients, widened into the masters' float32
        for _, p, m in self.low:
            if p.grad is None:
                continue
            if m.grad is None:
                m.grad = p.grad.float()
            else:
                m.grad.add_(p.grad)
            p.grad = None
        grads = [m.grad for m in self.masters if m.grad is not None]
        if not grads:
            raise RuntimeError("step() before any backward()")
        if self.micro_steps < self.accumulate_steps:
            return global_norm(grads) * (self.accumulate_steps
                                         / self.micro_steps)
        norm = clip_by_global_norm_(grads, self.grad_clip)
        self._set_lr()
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.low:
            with torch.no_grad():
                # a placed master is placed as its parameter: shard to shard
                torch._foreach_copy_([_local(p) for _, p, _ in self.low],
                                     [_local(m) for _, _, m in self.low])
        self.micro_steps = 0
        self.updates += 1
        return norm

    def model_state_dict(self, model: nn.Module) -> dict:
        """``model.state_dict()`` with the float32 masters in place of the
        parameters the model holds in a lower precision (the frozen ones'
        float32 values too), under every name of a shared parameter
        (Deformable-DETR's refinement heads are also the decoder's)."""
        params = dict(model.named_parameters())
        masters = {id(p): m.detach() for _, p, m in self.low}
        masters.update({id(params[name]): m
                        for name, m in self.frozen.items()})
        state = model.state_dict()
        for name, p in model.named_parameters(remove_duplicate=False):
            if id(p) in masters:
                state[name] = masters[id(p)]
        return state

    def load_masters(self, model_state: dict):
        """Set the masters from a state dict of whole tensors saved by
        ``model_state_dict`` (the model itself is loaded from it by
        ``load_state_dict``); a placed master takes its shard."""
        for name, _, m in self.low:
            copy_full_(m, model_state[name])
        for name, m in self.frozen.items():
            copy_full_(m, model_state[name])

    @torch.no_grad()
    def restore_float32(self, model: nn.Module):
        """Put the float32 masters back into the model as its parameters
        (undo the cast; the buffers stay as they are): a model this
        optimizer cast, made ready to be placed and given a new one."""
        params = dict(model.named_parameters())
        for name, p, m in self.low:
            set_data_(p, m.detach().clone())
        for name, m in self.frozen.items():
            set_data_(params[name], m.detach().clone())

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "micro_steps": self.micro_steps, "updates": self.updates}

    def load_state_dict(self, state: dict):
        """Load a state of whole tensors (any world size): each moment is
        placed as its parameter."""
        self.adamw.load_state_dict(state["adamw"])
        place_optimizer_state(self.adamw)
        self.micro_steps = state["micro_steps"]
        self.updates = state["updates"]

