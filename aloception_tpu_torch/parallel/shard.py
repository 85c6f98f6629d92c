"""Sharding rules over a mesh (counterpart of
``aloception_tpu/parallel/shard.py``): the batch over dp, wide Linears over
tp, large parameters over dp under FSDP, encoder tokens over sp.

The JAX package annotates arrays and lets XLA insert the collectives; here
each placement is made by hand over ``torch.distributed``:

- ``shard_batch``: every rank holds the global batch (as every JAX process
  does) and keeps its dp rows;
- ``partition_params``: tp places the wide Linears column-parallel as
  DTensors (``ColwiseParallel``, their outputs gathered after them, where
  XLA gathers them too); FSDP shards the parameters above
  ``_FSDP_MIN_SIZE`` elements with ``fully_shard`` over dp on the dim the
  rule names, at any sp (the sp ranks of one dp row hold the same shard),
  and leaves the others whole (``ignored_params``), their gradients
  averaged by ``sync_gradients``; a model that trains in bfloat16 keeps
  its shards in float32, cast where they are gathered;
- ``batch_count``: the criteria's denominators summed over dp, so that
  the mean of the ranks' gradients over dp x sp (DDP's, or FSDP's
  reduce-scatter over dp and the shards' mean over sp) is the gradient of
  the global batch's loss, as in the JAX package's one jit over the global
  batch;
- ``constrain_tokens``: the encoders' sequence-parallel hook.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import (axis_group, axis_rank, axis_size, current_mesh,
                   data_group, mesh_shape)

_FSDP_MIN_SIZE = 1 << 16     # parameters below 64K elements stay whole


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh, strict: bool = False) -> Any:
    """This rank's dp rows of every tensor of a (nested) global batch.

    A tensor whose leading dim does not divide by dp stays whole on every
    rank (``strict`` raises instead): small smoke batches run on a large
    mesh at the cost of redundant compute, as in the JAX package."""
    dp = axis_size(mesh, "dp")
    if dp == 1:
        return batch
    r = axis_rank(mesh, "dp")

    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if x.shape[0] % dp:
            if strict:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by dp={dp}")
            return x
        n = x.shape[0] // dp
        return x[r * n:(r + 1) * n]
    return _map(take, batch)


def replicate(tree: Any, mesh, src: int = 0) -> Any:
    """Every tensor of ``tree`` made equal on every rank to rank ``src``'s
    (in place, by a broadcast over the world); the tree itself without a
    mesh."""
    if mesh is None:
        return tree

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=src)
        return x
    return _map(bcast, tree)


def _flax_order(kind: Optional[str], ndim: int) -> Tuple[int, ...]:
    """Each torch dim's position in the flax layout of the same parameter,
    which breaks ties between equal dims as the JAX rule does: a Linear
    (out, in) is flax's (in, out), a conv (O, I, kh, kw) flax's
    (kh, kw, I, O)."""
    if kind == "linear" and ndim == 2:
        return (1, 0)
    if kind == "conv" and ndim == 4:
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def param_partition_spec(x, tp: int, dp: int = 1, fsdp: bool = False,
                         kind: Optional[str] = None) -> Tuple:
    """The placement of one parameter: a tuple with "tp", "dp" or None per
    dim, trailing Nones dropped (the JAX rule's ``PartitionSpec``).

    Tensor parallel: the weight of a Linear (``kind`` "linear"; flax's 2-D
    Dense kernel transposed) whose output dim is at least 512 and divides by
    tp shards that dim (column parallel), and its bias follows.

    FSDP: every parameter of at least ``_FSDP_MIN_SIZE`` elements is also
    sharded over dp on its largest dp-divisible dim not yet sharded (with
    dp 1 too, a shard that is the whole dim, as ``P("dp")`` on a mesh whose
    dp is 1)."""
    shape = tuple(x.shape)
    spec: List[Optional[str]] = [None] * len(shape)
    if tp > 1 and kind == "linear" and len(shape) in (1, 2) \
            and shape[0] % tp == 0 and shape[0] >= 512:
        spec[0] = "tp"
    numel = 1
    for s in shape:
        numel *= s
    if fsdp and numel >= _FSDP_MIN_SIZE:
        order = _flax_order(kind, len(shape))
        for d in sorted(range(len(shape)), key=lambda d: (-shape[d],
                                                          order[d])):
            if spec[d] is None and shape[d] % dp == 0:
                spec[d] = "dp"
                break
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _kind(module: nn.Module) -> Optional[str]:
    if isinstance(module, nn.Linear):
        return "linear"
    if isinstance(module, nn.Conv2d):
        return "conv"
    return None


def partition_specs(model: nn.Module, tp: int, dp: int = 1,
                    fsdp: bool = False) -> Dict[str, Tuple]:
    """{parameter name: its placement} for the trainable parameters of
    ``model`` (those that need a gradient) on a mesh of this tp and dp."""
    # nn.MultiheadAttention reads its out_proj's weight in a functional
    # call, never through the module: it stays a plain tensor (flax's
    # attention kernels are 3-D, which the JAX rule leaves to FSDP alone)
    inner = {id(m.out_proj) for m in model.modules()
             if isinstance(m, nn.MultiheadAttention)}
    specs = {}
    for mname, module in model.named_modules():
        kind = None if id(module) in inner else _kind(module)
        for pname, p in module.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f"{mname}.{pname}" if mname else pname
            specs[name] = param_partition_spec(p, tp, dp, fsdp, kind)
    return specs


def partition_params(model: nn.Module, mesh, fsdp: bool = False,
                     dtype: torch.dtype = torch.float32
                     ) -> List[nn.Parameter]:
    """Place ``model``'s parameters over ``mesh`` by the rule, in place:

    - tp > 1: each Linear whose weight's spec names "tp" becomes
      column-parallel over the tp axis (``ColwiseParallel``, its output
      gathered back to every tp rank);
    - ``fsdp``: ``fully_shard`` over dp on the module tree, each parameter
      of the rule on its dim, every other parameter left whole. With sp > 1
      each sp rank of a dp row holds the same shards (the JAX rule's
      ``P("dp")`` on a mesh with an sp axis); the caller averages their
      gradients over sp (``data_parallel``).

    ``dtype``: the precision the model will train in
    (``train.TrainOptimizer``). Under FSDP with a lower one the shards stay
    float32, and are the optimizer's masters: a mixed-precision policy
    casts them to ``dtype`` where they are gathered and widens their
    gradients to float32 before the reduce-scatter. What
    ``cast_for_training`` keeps in float32 (norms, the reference-point
    projection) is then left whole, since the policy casts every shard of
    the group.

    Returns the parameters that no ``fully_shard`` reduces, in the model's
    order (the same on every rank): the caller averages their gradients
    over ``data_group(mesh)`` (``sync_gradients``).
    A parameter that needs no gradient is not placed. Call before building
    the optimizer: both placements replace the module's parameters."""
    shape = mesh_shape(mesh)
    if shape["pp"] > 1:
        raise ValueError("partition_params: pp > 1 is pipeline.gpipe's "
                         "layer stacks, not the Trainer's")
    specs = partition_specs(model, shape["tp"], shape["dp"], fsdp)
    if shape["tp"] > 1:
        if mesh.device_type == "cpu" and any(
                p.is_cuda for p in model.parameters()):
            # a gloo mesh (ranks that share a card): DTensor would move the
            # tp Linears' inputs to the host, and its collectives over gloo
            # on CUDA tensors end the process (torch 2.11)
            raise NotImplementedError(
                "tensor parallelism of a model on the card needs NCCL, one "
                "card a rank; over gloo, place the model on the CPU")
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                       parallelize_module)
        plan = {name.rsplit(".", 1)[0]: ColwiseParallel(
                    output_layouts=Replicate())
                for name, spec in specs.items()
                if name.endswith(".weight") and spec[:1] == ("tp",)}
        if plan:
            parallelize_module(model, mesh["tp"], plan)
    if not fsdp:
        return [p for p in model.parameters() if p.requires_grad]
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard
    by_id = {id(p): specs.get(n) for n, p in model.named_parameters()}
    whole = {p for p in model.parameters()
             if not p.requires_grad or "dp" not in (by_id.get(id(p)) or ())}
    policy = MixedPrecisionPolicy()
    if dtype != torch.float32:
        from ..models.transformers import float32_kept
        kept = float32_kept(model)
        whole |= {p for p in model.parameters() if id(p) in kept}
        policy = MixedPrecisionPolicy(param_dtype=dtype,
                                      reduce_dtype=torch.float32,
                                      cast_forward_inputs=False)

    def placement(p):
        spec = by_id.get(id(p)) or ()
        # a tp parameter arrives as a DTensor: its dims are the full ones
        return Shard(spec.index("dp"))

    with torch.no_grad():
        # fully_shard takes contiguous parameters only (a conv weight on the
        # card is channels_last)
        for p in model.parameters():
            if p not in whole and not p.is_contiguous():
                p.data = p.data.contiguous()
    # over dp alone: a tp parameter is already a DTensor over tp, and
    # fully_shard makes it a dp x tp one (a 2-D mesh here would be HSDP)
    fully_shard(model, mesh=mesh["dp"], shard_placement_fn=placement,
                ignored_params=whole, reshard_after_forward=True,
                mp_policy=policy)
    return [p for p in model.parameters() if p.requires_grad and p in whole]


def fsdp_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is a shard that ``fully_shard`` manages (a DTensor on a
    mesh with a dp axis)."""
    mesh = getattr(p, "device_mesh", None)
    return mesh is not None and "dp" in (mesh.mesh_dim_names or ())


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor, the tensor itself otherwise."""
    return getattr(t, "_local_tensor", t)


@torch.no_grad()
def sync_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Average the gradients of ``params`` over ``group`` in place, one
    all-reduce per dtype over their flattened local tensors (what DDP's
    buckets do). Every rank passes them in one order."""
    if group is None:
        return
    grads = [_local(p.grad) for p in params if p.grad is not None]
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def batch_count(count: torch.Tensor, minimum: Optional[float] = 1.0
                ) -> torch.Tensor:
    """A criterion's denominator (a count of valid targets or pixels, a sum
    of weights) as the global batch's, divided by dp.

    Each rank's loss, a sum over its rows over this count, then averages
    over the ranks to the global batch's loss, and so does its gradient
    (DDP averages them): the JAX package's one jit over the global batch.
    The global count is clamped at ``minimum`` before the division. Outside
    a mesh with dp > 1 (``use_mesh``), the count clamped, as it was."""
    count = count.detach().float()
    mesh = current_mesh()
    group = axis_group(mesh, "dp")
    if group is not None:
        count = count.clone()
        dist.all_reduce(count, group=group)
    if minimum is not None:
        count = count.clamp(min=minimum)
    return count / axis_size(mesh, "dp")


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) whose gradient is the all-reduced (summed)
    gradient: each rank's output feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the dp group of the entered mesh, carrying
    gradients (RAFT's BatchNorm statistics); None outside one."""
    group = axis_group(current_mesh(), "dp")
    if group is None:
        return None
    return _AllReduceSum.apply(x, group)


class _GatherTokens(torch.autograd.Function):
    """All-gather of token shards along dim 1. Its gradient is the sum over
    the ranks of their gradients of the full tensor, sliced to this rank's
    shard (a reduce-scatter, written as an all-reduce, which gloo has)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.rank, ctx.n = group, rank, n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.chunk(ctx.n, 1)[ctx.rank].contiguous(), None, None, None


class SequenceShard:
    """This rank's slice of an encoder's token axis (dim 1) over the sp
    group: tokens ``[rank * n, (rank + 1) * n)`` of the sequence padded to
    ``sp * n``. ``gather`` undoes ``split`` (an all-gather that carries
    gradients), dropping the padding."""

    def __init__(self, length: int, group, rank: int, size: int):
        self.length, self.group, self.rank, self.size = \
            length, group, rank, size
        self.local = -(-length // size)
        self.padded = self.local * size

    def split(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.length:
            return x
        if self.padded != self.length:
            pad = x.new_zeros(x.shape[0], self.padded - self.length,
                              *x.shape[2:])
            x = torch.cat([x, pad], 1)
        return x[:, self.rank * self.local:(self.rank + 1) * self.local]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        full = _GatherTokens.apply(x, self.group, self.rank, self.size)
        return full[:, :self.length]


def sequence_shard(length: int, axis: str = "sp") -> Optional[SequenceShard]:
    """The token split of a sequence of ``length`` over ``axis`` of the
    entered mesh, or None off-mesh or with the axis of size 1."""
    mesh = current_mesh()
    group = axis_group(mesh, axis)
    if group is None:
        return None
    return SequenceShard(length, group, axis_rank(mesh, axis),
                         axis_size(mesh, axis))


def constrain_tokens(x: torch.Tensor, shard: Optional[SequenceShard]
                     ) -> torch.Tensor:
    """Sequence-parallel hook, called in the encoder loops where the JAX
    package calls its own: with no shard (no mesh, or sp == 1) an identity;
    otherwise ``x`` (B, L, C) is cut to this rank's tokens (B, L / sp, C),
    where it is still whole, so that LayerNorm and the FFN run on the
    shard."""
    return x if shard is None else shard.split(x)


def full_tensors(tree: Any) -> Any:
    """``tree`` with every DTensor replaced by its whole tensor (a
    collective: every rank calls it, in one order)."""
    return _map(lambda x: x.full_tensor() if hasattr(x, "_local_tensor")
                else x, tree)


def _place_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` as a shard placed like the DTensor ``like``; ``full`` on
    ``like``'s device otherwise."""
    full = full.to(device=like.device, dtype=like.dtype)
    if not hasattr(like, "_local_tensor"):
        return full
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, like.device_mesh, like.placements)


@torch.no_grad()
def copy_full_(target: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """Copy the whole tensor ``full`` into ``target`` in place: its shard
    where ``target`` is a DTensor. Returns ``target``."""
    _local(target).copy_(_local(_place_like(full, target)))
    return target


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]):
    """Load whole tensors (a checkpoint of any world size) into a model
    whose parameters may be DTensors: each takes its shard. Strict, as
    ``load_state_dict``."""
    own = model.state_dict()
    if set(own) != set(state):
        raise KeyError(f"state dict mismatch: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    for name, target in own.items():
        if state[name].shape != target.shape:
            raise RuntimeError(f"size mismatch for {name}: "
                               f"{tuple(state[name].shape)} in the state, "
                               f"{tuple(target.shape)} in the model")
        copy_full_(target, state[name])


def place_optimizer_state(optimizer: torch.optim.Optimizer):
    """After ``load_state_dict`` of whole tensors: each moment placed as its
    parameter (a DTensor's shard), as the JAX Trainer places the optax
    state with its parameters' rule."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape \
                        and v.dim() > 0:
                    state[k] = _place_like(v, p)


def data_parallel(model: nn.Module, mesh, fsdp: bool = False,
                  dtype: torch.dtype = torch.float32):
    """The placement the Trainer gives ``model`` over ``mesh``: (the module
    whose forward trains, the function to call after each backward that
    averages the gradients the placement leaves unaveraged, or None where
    nothing has to).

    - tp > 1 or ``fsdp``: ``partition_params`` (the module trains itself;
      the parameters it leaves whole are averaged by hand over dp x sp, and
      FSDP's shards, which its reduce-scatter averages over dp, over sp);
    - otherwise DDP over the dp x sp ranks (a world of one too, as
      Lightning's ddp strategy on one card), without broadcasting buffers
      (RAFT's BatchNorm statistics are the global batch's on every rank
      already);
    - no mesh, or a rank alone in dp x sp: the model, nothing to sync.

    Either way each parameter's gradient is the mean over the dp x sp ranks,
    which the criteria's ``batch_count`` makes the global batch's.
    ``dtype`` is the precision the model will train in
    (``partition_params``). Placing replaces parameters: build the
    optimizer after."""
    shape = mesh_shape(mesh)
    if fsdp and mesh is None:
        raise ValueError("fsdp needs a process group "
                         "(parallel.init_multihost)")
    if shape["tp"] > 1 or fsdp:
        whole = partition_params(model, mesh, fsdp, dtype)
        syncs = [(whole, data_group(mesh))]
        if fsdp and shape["sp"] > 1:
            ids = {id(p) for p in whole}
            syncs.append(([p for p in model.parameters()
                           if p.requires_grad and id(p) not in ids],
                          axis_group(mesh, "sp")))

        def after_backward():
            for params, group in syncs:
                sync_gradients(params, group)
        return model, after_backward
    group = data_group(mesh)
    if group is None:
        return model, None
    device = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        model, process_group=group, broadcast_buffers=False,
        device_ids=[device.index] if device.type == "cuda" else None), None
