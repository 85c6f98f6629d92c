"""GPipe pipeline parallelism over the mesh's ``pp`` axis (counterpart of
``aloception_tpu/parallel/pipeline.py``).

A homogeneous layer stack (DETR's encoder layers) has its per-layer
parameters stacked on a leading layer axis; each pp rank holds its stage's
contiguous ``n_layers / pp`` layers. Every rank runs the same schedule: at
tick ``t`` stage ``s`` works on microbatch ``t - s`` and hands its output to
stage ``s + 1``, the GPipe schedule with its (S-1)/(M+S-1) bubble. The hand
over is the JAX package's ``lax.ppermute``, written as paired send/recv
(``batch_isend_irecv``) inside an autograd function whose backward sends the
gradient back the other way, so the same function trains.

Hand-written send/recv rather than ``torch.distributed.pipelining``: the
schedule is the JAX package's, microbatch by microbatch with the extras in
step, and its backward is plain autograd, so a stage is any
``layer_apply`` and nothing is traced or split. As in the JAX package every
stage computes at every tick (on its zero bootstrap input in the bubble)
and stage 0 picks its injected microbatch with a ``where``: every rank then
holds the same graph, each hand-over's backward runs on every rank in the
same order (tick by tick, last first), and no send waits for a receive that
one rank's autograd skipped.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .mesh import axis_group, axis_rank, axis_size
from .shard import _map


def stack_layer_params(layers: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Stack N structurally identical layers (modules or {name: tensor}
    dicts) on a new leading layer axis: {name: (N, ...)}, leaves that need a
    gradient."""
    dicts = [dict(m.named_parameters()) if isinstance(m, nn.Module) else m
             for m in layers]
    return {k: torch.stack([d[k].detach() for d in dicts]).requires_grad_()
            for k in dicts[0]}


def extract_layer_stack(params: Any, prefix: str, n_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """Pull ``{prefix}0.`` .. ``{prefix}{n-1}.`` out of a model or a state
    dict (e.g. the Transformer's ``encoder.layers.``) and stack them."""
    flat = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else params
    layers = []
    for i in range(n_layers):
        head = f"{prefix}{i}."
        layers.append({k[len(head):]: v for k, v in flat.items()
                       if k.startswith(head)})
    return stack_layer_params(layers)


def shard_layer_stack(stacked: Dict[str, torch.Tensor], mesh,
                      axis: str = "pp") -> Dict[str, torch.Tensor]:
    """This rank's stage of a stacked layer tree: its contiguous slice of the
    layer axis, as leaves that need a gradient."""
    S = axis_size(mesh, axis)
    n = next(iter(stacked.values())).shape[0]
    if n % S:
        raise ValueError(f"{n} layers not divisible by {axis}={S}")
    k, s = n // S, axis_rank(mesh, axis)
    return {name: t.detach()[s * k:(s + 1) * k].clone().requires_grad_()
            for name, t in stacked.items()}


def _shift(x: torch.Tensor, group, src, dst) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and return what global rank
    ``src`` sent (zeros where None)."""
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dst, group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    """Stage s -> s + 1 (``lax.ppermute``); its gradient goes s + 1 -> s."""

    @staticmethod
    def forward(ctx, x, group, prev, nxt):
        ctx.group, ctx.prev, ctx.nxt = group, prev, nxt
        return _shift(x, group, prev, nxt)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, ctx.nxt, ctx.prev), None, None, None


class _FromLast(torch.autograd.Function):
    """The sum over the pp group of tensors that are zero except on the last
    stage: its rows on every stage. The gradient stays on its own rank: the
    caller's loss, computed alike on every stage, counts once."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gpipe(layer_apply: Callable, stacked_params: Dict[str, torch.Tensor],
          x: torch.Tensor, extras: Any, mesh, n_micro: int,
          axis: str = "pp") -> torch.Tensor:
    """Run a homogeneous layer stack as a pipeline over ``mesh[axis]``.

    layer_apply(p_layer, act, extras) -> act: ONE layer's forward, ``act``
        keeping its shape ((B_micro, L, C) for a transformer stack).
    stacked_params: this rank's stage (``shard_layer_stack``), its layers
        stacked on axis 0.
    x: this rank's rows (B, ...) of the input (``shard_batch`` over dp),
        cut into ``n_micro`` microbatches.
    extras: a tree of (B, ...) side inputs every layer reads (positions,
        padding masks), microbatched in step with ``x``.

    Returns the stack's output for the rows, (B, ...), on every stage: the
    last stage's rows, kept by a ``where`` and summed over pp. Not a
    multiply by a mask, which the JAX package warns against: an earlier
    stage's rows may hold NaN where a layer met its zero bootstrap input,
    and NaN * 0 is NaN."""
    S = axis_size(mesh, axis)
    s = axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    if x.shape[0] % n_micro:
        raise ValueError(f"local batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    micro_x = x.chunk(n_micro)
    micro_ex = [_map(lambda e, m=m: e.chunk(n_micro)[m], extras)
                for m in range(n_micro)]
    n_local = next(iter(stacked_params.values())).shape[0]

    def local_stage(act, ex):
        for i in range(n_local):
            act = layer_apply({k: v[i] for k, v in stacked_params.items()},
                              act, ex)
        return act

    if group is None:
        return torch.cat([local_stage(a, e)
                          for a, e in zip(micro_x, micro_ex)])
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < S - 1 else None
    first = torch.tensor(s == 0, device=x.device)
    received = torch.zeros_like(micro_x[0])
    outs = []
    for t in range(n_micro + S - 1):
        # stage 0 injects microbatch t; the others work on what the
        # hand-over delivered last tick (microbatch t - s)
        act = torch.where(first, micro_x[min(t, n_micro - 1)], received)
        out = local_stage(act, micro_ex[min(max(t - s, 0), n_micro - 1)])
        outs.append(out)
        received = _PPermute.apply(out, group, prev, nxt)
    # microbatch m leaves the last stage at tick m + S - 1
    ys = torch.cat(outs[S - 1:])
    ys = torch.where(torch.tensor(s == S - 1, device=ys.device), ys,
                     torch.zeros_like(ys))
    return _FromLast.apply(ys, group)
