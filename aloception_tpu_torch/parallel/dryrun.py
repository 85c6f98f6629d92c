"""Multi-rank dry run on CPU processes (counterpart of
``__graft_entry__.py::dryrun_multichip``):

    python -m aloception_tpu_torch.parallel.dryrun 8

N spawned processes form a gloo group and run one tiny DETR train step
under each placement the JAX dry run compiles, with its checks that the
sharding is real:

1. dp x tp (tp 2 when N >= 4 is even): a rank holds B / dp rows, a tp
   parameter holds 1 / tp of its elements, the step runs at least one
   all-reduce and, under tp, at least 2 collectives;
2. FSDP on the same mesh: a parameter holds 1 / dp of its elements, the
   step all-gathers; the loss within 1e-3 of pass 1's;
3. sequence parallel (N divisible by 8): dp 2, sp 2, tp 2, the encoder's
   tokens split over sp; the loss within 1e-3 of pass 1's; then the same
   for a tiny Deformable-DETR (refine), whose MSDA samples for the rank's
   Lq / sp queries;
4. pipeline (N even): a stack of 4 DETR encoder layers as a pp 2 GPipe
   pipeline, its forward within 1e-2 (relative) of the sequential stack's,
   its gradients finite.

Every pass's loss is also held against the replicated step (the same model
on the whole batch in one process). Collectives are counted by
``CommDebugMode`` (the c10d and functional collectives the step calls) and
by a DDP communication hook. ``spawn`` is what the tests use to start their
ranks: a rank that fails or hangs fails the run, and its traceback is
raised.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

TINY_DETR = dict(num_classes=10, hidden_dim=64, num_queries=20, nheads=4,
                 num_encoder_layers=2, num_decoder_layers=2,
                 # 64 x 1024 kernels cross the FSDP size threshold and tp's
                 # 512, so both placements have something to shard
                 dim_feedforward=1024, stage_sizes=(1, 1, 1, 1), dropout=0.0)
# a padded image of 64 x 64 has a coarsest Deformable level that is all
# padding (valid ratio 0, NaN reference points, in both packages)
HW = (64, 96)
N_TARGETS = 8
PASSES = ("dp_tp", "fsdp", "sp", "sp_deformable")


def _rank_main(rank: int, n: int, init_file: str, out_dir: str,
               fn: Callable, args: tuple, threads: int, device: str,
               backend):
    path = os.path.join(out_dir, f"{rank}.pt")
    try:
        torch.set_num_threads(threads)
        from .distributed import init_multihost
        init_multihost(f"file://{init_file}", n, rank, device=device,
                       backend=backend)
        result = fn(rank, n, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save({"result": result}, path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
        raise SystemExit(1)


def spawn(n: int, fn: Callable, *args, timeout: float = 600.0,
          threads: int = 1, device: str = "cpu",
          backend: str = None) -> List[Any]:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned processes that form a
    process group (``init_multihost``: gloo on the CPU by default; with
    ``device`` "cuda" each binds its card, over NCCL unless ``backend``
    says otherwise); returns each rank's result (anything ``torch.save``
    takes). ``fn`` is a module-level function (the processes import it).
    When a rank fails, or the run outlasts ``timeout`` seconds, every rank
    is stopped and the error raised."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, init_file, tmp, fn, args, threads,
                                   device, backend))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"{r}.pt")
            saved = torch.load(path, weights_only=False) \
                if os.path.exists(path) else {}
            if "error" in saved:
                raise RuntimeError(f"rank {r} of {n} failed:\n"
                                   f"{saved['error']}")
            if p.exitcode != 0 or "result" not in saved:
                raise RuntimeError(
                    f"rank {r} of {n} ended with exit code {p.exitcode} "
                    f"(stopped after {timeout:.0f} s, or killed)")
            results.append(saved["result"])
        return results


def detr_batch(B: int, seed: int = 0, hw=HW, n_targets: int = N_TARGETS
               ) -> Dict:
    """A seeded DETR batch: normalised-looking images (B, H, W, 3), a mask
    with padding on odd rows, targets whose valid counts differ by row."""
    rng = np.random.RandomState(seed)
    H, W = hw
    images = rng.randn(B, H, W, 3).astype(np.float32)
    mask = np.zeros((B, H, W), np.float32)
    mask[1::2, :, W * 3 // 4:] = 1.0
    valid = np.arange(n_targets)[None] < rng.randint(1, n_targets + 1,
                                                     (B, 1))
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, n_targets, 2)),
                            rng.uniform(0.1, 0.4, (B, n_targets, 2))], -1)
    return {"inputs": (torch.from_numpy(images), torch.from_numpy(mask)),
            "targets": {
                "boxes": torch.from_numpy((boxes * valid[..., None])
                                          .astype(np.float32)),
                "labels": torch.from_numpy(rng.randint(0, 10, (B, n_targets))
                                           * valid).long(),
                "valid": torch.from_numpy(valid)}}


class CollectiveCount:
    """Counts the collectives of a block: the c10d and functional collective
    ops it dispatches (DTensor's, FSDP's and ``torch.distributed``'s), as
    ``CommDebugMode`` counts them but without its module tracker, plus the
    all-reduces of the DDP buckets it is ``hook``ed into (DDP's reducer
    calls its process group directly)."""

    NAMES = {"allreduce_": "all_reduce", "all_reduce": "all_reduce",
             "allgather_": "all_gather", "_allgather_base_": "all_gather",
             "all_gather_into_tensor": "all_gather",
             "allgather_into_tensor_coalesced_": "all_gather",
             "reduce_scatter_tensor": "reduce_scatter",
             "_reduce_scatter_base_": "reduce_scatter",
             "reduce_scatter_tensor_coalesced_": "reduce_scatter",
             "broadcast_": "broadcast", "send": "send", "recv_": "recv"}

    def __init__(self):
        self.counts: Dict[str, int] = {"all_reduce": 0}
        self._mode = None

    def hook(self, ddp: torch.nn.parallel.DistributedDataParallel):
        from torch.distributed.algorithms.ddp_comm_hooks.default_hooks \
            import allreduce_hook

        def counting(state, bucket):
            self.counts["all_reduce"] += 1
            return allreduce_hook(state, bucket)
        ddp.register_comm_hook(ddp.process_group, counting)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        counts, names = self.counts, self.NAMES

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                flat, _ = tree_flatten((args, kwargs))
                if any(isinstance(t, DTensor) for t in flat):
                    # let DTensor run first and desugar into collectives
                    return NotImplemented
                name = names.get(func._opname) if func.namespace in (
                    "c10d", "_c10d_functional") else None
                if name:
                    counts[name] = counts.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _losses(keys, packed) -> Dict[str, float]:
    return dict(zip(keys, packed.tolist()))


def replicated_step(make_model: Callable, criterion: Callable, batch: Dict
                    ) -> Dict[str, float]:
    """One train step of the model on the whole batch in this process, no
    mesh: the reference of every placement."""
    from ..train.state import TrainOptimizer
    from ..train.step import make_train_step
    model = make_model()
    step = make_train_step(model, TrainOptimizer(model), criterion)
    return _losses(*step(*[batch[k] for k in ("inputs", "targets")]))


def placed_step(make_model: Callable, criterion: Callable, batch: Dict,
                tp: int = 1, sp: int = 1, fsdp: bool = False) -> Dict:
    """One train step of the model as the Trainer places it on a mesh of
    the world with this tp and sp: the global metrics and the checks that
    the placement is real (this rank's rows, a tp and a dp parameter's
    share of its elements, the collectives counted)."""
    from .mesh import axis_size, make_mesh, use_mesh
    from .shard import data_parallel, shard_batch, sync_gradients
    from .mesh import data_group
    from ..train.state import TrainOptimizer
    from ..train.step import make_train_step
    mesh = make_mesh(tp=tp, sp=sp)
    model = make_model()
    forward, sync = data_parallel(model, mesh, fsdp)
    count = CollectiveCount()
    if isinstance(forward, torch.nn.parallel.DistributedDataParallel):
        count.hook(forward)
    opt = TrainOptimizer(model)
    step = make_train_step(
        forward, opt, criterion, after_backward=None if sync is None else
        lambda: sync_gradients(sync, data_group(mesh)))
    inputs, targets = shard_batch((batch["inputs"], batch["targets"]), mesh)
    with use_mesh(mesh), count:
        keys, packed = step(inputs, targets)
    dist.all_reduce(packed)
    packed = packed / dist.get_world_size()
    shares = {}
    for name, p in model.named_parameters():
        local = getattr(p, "_local_tensor", p)
        placements = [str(pl) for pl in getattr(p, "placements", ())]
        if placements:
            shares[name] = (local.numel() / p.numel(), placements)
    return {"metrics": _losses(keys, packed),
            "rows": int(inputs[0].shape[0]),
            "dp": axis_size(mesh, "dp"), "sp": axis_size(mesh, "sp"),
            "tp": axis_size(mesh, "tp"),
            "shares": shares, "collectives": dict(count.counts)}


def _tiny_detr():
    from ..models.detr import Detr
    return Detr(device="cpu", **TINY_DETR)


def _tiny_deformable():
    from ..models.deformable_detr import DeformableDETR
    return DeformableDETR(with_box_refine=True, device="cpu", **TINY_DETR)


def placement_passes(rank: int, n: int) -> Dict:
    """Passes 1-3 of the dry run on this rank (``spawn``); pass 3 also runs
    Deformable-DETR (refine), whose MSDA samples for the rank's queries."""
    from ..models.deformable_detr import deformable_criterion
    from ..models.detr.criterion import detr_criterion
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    batch = detr_batch(dp * 2)
    sp = n % 8 == 0
    # the references, on two ranks while the others wait
    out = {"replicated": {
        "detr": replicated_step(_tiny_detr, detr_criterion, batch)
        if rank == 0 else None,
        "deformable": replicated_step(_tiny_deformable,
                                      deformable_criterion, batch)
        if sp and rank == n - 1 else None},
        "dp_tp": placed_step(_tiny_detr, detr_criterion, batch, tp=tp),
        "fsdp": placed_step(_tiny_detr, detr_criterion, batch, tp=tp,
                            fsdp=True)}
    if sp:
        out["sp"] = placed_step(_tiny_detr, detr_criterion, batch, tp=2,
                                sp=2)
        out["sp_deformable"] = placed_step(
            _tiny_deformable, deformable_criterion, batch, tp=2, sp=2)
    return out


def encoder_stack(n_layers: int = 4, d: int = 64, heads: int = 4,
                  ffn: int = 256, seed: int = 10):
    """``n_layers`` DETR encoder layers with seeded weights."""
    from ..models.detr.transformer import EncoderLayer
    layers = []
    for i in range(n_layers):
        torch.manual_seed(seed + i)
        layers.append(EncoderLayer(d, heads, ffn, dropout=0.0))
    return layers


def pipeline_pass(rank: int, n: int, pp: int = 2, n_micro: int = 2,
                  stack: Dict = None, inputs: Dict = None,
                  dims=(64, 4, 256)) -> Dict:
    """Pass 4: a stack of encoder layers of (d_model, heads, feed-forward)
    ``dims`` (``stack``: {name: (N, ...)} of numpy arrays, else
    ``encoder_stack``'s) on this rank's dp rows of ``inputs`` (x, pos,
    mask: (B, L, C), (B, L, C), (B, L) bool) as a GPipe pipeline over pp,
    against the sequential stack on the same rows: the outputs, the loss
    sum(out ** 2) and this stage's layers' gradients, and those gradients
    summed over dp (the global loss's)."""
    from torch.func import functional_call
    from .mesh import axis_group, axis_rank, axis_size, make_mesh
    from .pipeline import gpipe, shard_layer_stack, stack_layer_params
    from .shard import shard_batch
    mesh = make_mesh(pp=pp)
    layers = encoder_stack(4, *dims)
    layer = layers[0]
    if stack is None:
        stacked = stack_layer_params(layers)
    else:
        stacked = {k: torch.from_numpy(v).requires_grad_()
                   for k, v in stack.items()}
    if inputs is None:
        rngs = np.random.RandomState(2)
        inputs = {"x": rngs.randn(n, 24, 64).astype(np.float32),
                  "pos": rngs.randn(n, 24, 64).astype(np.float32),
                  "mask": np.zeros((n, 24), bool)}
    x, pos, mask = shard_batch(
        [torch.from_numpy(inputs[k]) for k in ("x", "pos", "mask")], mesh)

    def apply_one(p, a, ex):
        return functional_call(layer, p, (a, ex["pos"], ex["mask"]))

    local = shard_layer_stack(stacked, mesh)
    out = gpipe(apply_one, local, x, {"pos": pos, "mask": mask}, mesh,
                n_micro=n_micro)
    loss = (out ** 2).sum()
    loss.backward()

    seq_params = {k: v.detach().clone().requires_grad_()
                  for k, v in stacked.items()}
    seq = x
    n_layers = next(iter(stacked.values())).shape[0]
    for i in range(n_layers):
        seq = apply_one({k: v[i] for k, v in seq_params.items()}, seq,
                        {"pos": pos, "mask": mask})
    seq_loss = (seq ** 2).sum()
    seq_loss.backward()
    k, s = n_layers // axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    grads = {name: t.grad for name, t in local.items()}
    dp_grads = {name: g.clone() for name, g in grads.items()}
    group = axis_group(mesh, "dp")
    for g in dp_grads.values():
        if group is not None:
            dist.all_reduce(g, group=group)
    return {"out": out.detach(), "seq": seq.detach(),
            "loss": loss.item(), "seq_loss": seq_loss.item(),
            "grads": grads,
            "seq_grads": {name: t.grad[s * k:(s + 1) * k]
                          for name, t in seq_params.items()},
            "dp_grads": dp_grads, "stage": s, "layers": (s * k, (s + 1) * k),
            "dp_rank": axis_rank(mesh, "dp"), "rows": int(x.shape[0])}


def check(results: List[Dict], pipe: List[Dict]) -> List[str]:
    """The dry run's checks on every rank's results; the lines it prints.
    Raises AssertionError on the first that fails."""
    lines = []
    base = results[0]["dp_tp"]
    for tag in PASSES:
        if tag not in results[0]:
            continue
        model = "deformable" if tag.endswith("deformable") else "detr"
        ref = results[0]["replicated"][model]["loss_total"]
        for r, res in enumerate(results):
            got = res[tag]
            loss = got["metrics"]["loss_total"]
            assert np.isfinite(loss), (tag, r, loss)
            assert abs(loss - ref) <= 1e-4 * max(1.0, abs(ref)), \
                (tag, r, loss, ref)
            if model == "detr":
                assert abs(loss - base["metrics"]["loss_total"]) < 1e-3
            assert got["rows"] * got["dp"] == 2 * base["dp"], \
                (tag, r, got["rows"])
            c = got["collectives"]
            assert c.get("all_reduce", 0) > 0, (tag, r, c)
            if got["tp"] > 1:
                assert sum(c.values()) >= 2, (tag, r, c)
                tp_share = [s for s, pl in got["shares"].values()
                            if len(pl) == 1 and s == 1 / got["tp"]]
                assert tp_share, f"{tag}: no parameter holds 1/tp"
            if tag == "fsdp":
                dp_share = [s for s, pl in got["shares"].values()
                            if s == 1 / got["dp"]]
                assert dp_share, "fsdp: no parameter holds 1/dp"
                assert c.get("all_gather", 0) > 0, (r, c)
        c = results[0][tag]["collectives"]
        lines.append(
            f"dryrun {tag} OK: {model}, dp={results[0][tag]['dp']} "
            f"sp={results[0][tag]['sp']} tp={results[0][tag]['tp']}, loss "
            f"{results[0][tag]['metrics']['loss_total']:.6f} (replicated "
            f"{ref:.6f}), {results[0][tag]['rows']} rows a rank, "
            f"collectives {c}")
    if not pipe:
        return lines
    for r, res in enumerate(pipe):
        assert torch.isfinite(res["out"]).all()
        want = res["seq_loss"]
        assert abs(res["loss"] - want) < 1e-2 * max(1.0, abs(want)), \
            (r, res["loss"], want)
        for name, g in res["grads"].items():
            assert torch.isfinite(g).all(), (r, name)
    lines.append(f"dryrun pp OK: pp=2, encoder-stack GPipe forward "
                 f"{pipe[0]['loss']:.3f} against sequential "
                 f"{pipe[0]['seq_loss']:.3f} on rank 0's rows")
    return lines


def all_passes(rank: int, n: int) -> Dict:
    """Passes 1-4 on this rank, the pipeline's under "pipe"."""
    out = placement_passes(rank, n)
    if n % 2 == 0:
        out["pipe"] = pipeline_pass(rank, n)
    return out


def dryrun(n: int) -> List[str]:
    """Passes 1-4 on ``n`` CPU ranks (one spawn); the lines of its
    report."""
    results = gather_references(spawn(n, all_passes))
    pipe = [r.pop("pipe") for r in results if "pipe" in r]
    return check(results, pipe)


def gather_references(results: List[Dict]) -> List[Dict]:
    """Rank 0's "replicated" entry holding every rank's references."""
    for res in results[1:]:
        for k, v in res["replicated"].items():
            if v is not None:
                results[0]["replicated"][k] = v
    return results


if __name__ == "__main__":
    for line in dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 8):
        print(line)
