"""What the ranks of the multi-rank CPU tests run (``parallel.dryrun.spawn``
starts them). This module imports numpy, torch and the port only: a rank is
a process of the port alone, as on the card.

``trainer_steps`` drives ``Trainer.fit`` under a process group: tiny DETR,
Deformable-DETR (box refinement) and RAFT, each one step from given weights
on this rank's rows of a given global batch, then a run resumed from a
checkpoint that one process wrote. It reports what each step gave and
what each rank wrote."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

# one encoder layer, two decoder layers: the auxiliary outputs' losses and
# matching stay in the step
DETR_TINY = dict(num_classes=5, hidden_dim=64, num_queries=20, nheads=4,
                 num_encoder_layers=1, num_decoder_layers=2,
                 dim_feedforward=128, stage_sizes=(1, 1, 1, 1), dropout=0.0)
# feed-forward 1024: its 64 x 1024 kernels cross FSDP's size threshold and
# tp's 512, so that both placements shard something
PLACED_TINY = dict(DETR_TINY, dim_feedforward=1024)
RAFT_TINY = dict(hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=2)
RAFT_ITERS = 3


class Capture:
    """A callback that keeps each train batch's metrics."""

    def __init__(self):
        self.metrics = []

    def on_train_batch_end(self, trainer, metrics, step):
        self.metrics.append(dict(metrics))

    def on_val_batch_end(self, *a): ...
    def on_val_epoch_end(self, *a): ...
    def on_epoch_end(self, *a): ...


def build(name: str, tiny: Dict = None):
    from aloception_tpu_torch.models import deformable_detr, detr, raft
    tiny = tiny or DETR_TINY
    if name == "detr":
        return detr.Detr(device="cpu", **tiny)
    if name == "deformable":
        return deformable_detr.DeformableDETR(with_box_refine=True,
                                              device="cpu", **tiny)
    return raft.built(raft.RAFTBase(device="cpu", **RAFT_TINY),
                      torch.float32)


def criterion_of(name: str):
    from aloception_tpu_torch.models import deformable_detr, detr, raft
    if name == "detr":
        return detr.detr_criterion
    if name == "deformable":
        return deformable_detr.deformable_criterion

    def raft_criterion(flows, targets):
        return raft.raft_sequence_loss(flows, targets["flow"],
                                       valid=targets["valid"])
    return raft_criterion


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(torch_tree(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def make_trainer(name: str, state: Dict, batch: Dict, root: str,
                 run_id: str, callback: Capture, log=None, tiny=None, **kw):
    """A Trainer of model ``name`` (of ``tiny``'s sizes) loaded with
    ``state`` (numpy), whose every batch is ``batch`` (numpy, global),
    writing under ``root``."""
    from aloception_tpu_torch.train import Trainer
    model = build(name, tiny)
    model.load_state_dict(torch_tree(state), strict=True)
    global_batch = torch_tree(batch)
    return Trainer(model, criterion_of(name),
                   prepare_batch=lambda raw, training=True: global_batch,
                   forward_kwargs={"iters": RAFT_ITERS}
                   if name == "raft" else None,
                   callbacks=[callback], log=log, log_dir=root,
                   project=name, expe_name="parallel", run_id=run_id, **kw)


def numpy_state(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def trainer_steps(rank: int, n: int, cfg: Dict) -> Dict:
    """cfg: {"root", "config_path", "models": {name: (state, batch)},
    "resume": (name, state, batch, run_id), "resume_fsdp": the same}. One
    ``fit`` step of each model, then the resumed runs' steps (DDP, and
    FSDP: the checkpoint's whole tensors loaded into the shards)."""
    from aloception_tpu_torch.parallel import shard_batch
    from aloception_tpu_torch.train import experiment
    experiment.CONFIG_PATH = cfg["config_path"]
    out = {}
    for name, (state, batch) in cfg["models"].items():
        cap = Capture()
        trainer = make_trainer(name, state, batch, cfg["root"],
                               run_id=f"{name}-2", callback=cap,
                               log="tensorboard" if name == "detr" else None)
        trainer.fit([None], max_steps=1)
        out[name] = {"metrics": cap.metrics, "state": numpy_state(
            trainer.model), "ckpt_dir": trainer.ckpt_dir,
            "writes": trainer.ckpt.write,
            "logger": type(trainer.logger).__name__,
            "forward": type(trainer.forward_model).__name__,
            "rows": int(shard_batch(trainer.prepare_batch(None)["inputs"][0],
                                    trainer.mesh).shape[0])}
        torch.distributed.barrier()
        out[name]["files"] = sorted(
            os.path.relpath(os.path.join(d, f), trainer.ckpt_dir)
            for d, _, fs in os.walk(trainer.ckpt_dir) for f in fs)
    for key, fsdp in (("resume", False), ("resume_fsdp", True)):
        name, state, batch, run_id = cfg[key]
        cap = Capture()
        trainer = make_trainer(name, state, batch, cfg["root"],
                               run_id=run_id, callback=cap, fsdp=fsdp)
        trainer.fit([None], max_steps=2, resume=True)
        full = trainer.state_dict()["model"]
        out[key] = {"metrics": cap.metrics, "step": trainer.global_step,
                    "state": {k: v.cpu().numpy() for k, v in full.items()},
                    "ckpt_dir": trainer.ckpt_dir,
                    "sharded": sorted(n for n, p in
                                      trainer.model.named_parameters()
                                      if hasattr(p, "_local_tensor"))}
    return out


def _whole(t: torch.Tensor) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "_local_tensor") else t
    return t.detach().float().cpu().numpy().copy()


def capture_gradients(optimizer, model) -> Dict[str, np.ndarray]:
    """{name: the float32 gradient the first update is given, whole},
    filled when ``optimizer`` (a ``TrainOptimizer``) first updates."""
    names = {id(p): n for n, p in model.named_parameters()}
    by_master = [(names[id(p)], m) for p, m in zip(optimizer.params,
                                                   optimizer.masters)]
    grads = {}
    step = optimizer.adamw.step

    def capture(*a, **kw):
        if not grads:
            grads.update({n: _whole(m.grad) for n, m in by_master})
        return step(*a, **kw)
    optimizer.adamw.step = capture
    return grads


def one_process_step(name: str, state: Dict, batch: Dict,
                     dtype=torch.float32, tiny=None, **opt_kw) -> Dict:
    """One train step of model ``name`` from ``state`` on the whole global
    ``batch`` in this process, no mesh, computing in ``dtype`` (what the
    Trainer steps without a process group): its metrics, the gradients the
    update is given and the float32 masters after it."""
    from aloception_tpu_torch.train import TrainOptimizer
    from aloception_tpu_torch.train.step import make_train_step
    model = build(name, tiny)
    model.load_state_dict(torch_tree(state), strict=True)
    opt = TrainOptimizer(model, dtype=dtype, **opt_kw)
    grads = capture_gradients(opt, model)
    b = torch_tree(batch)
    keys, packed = make_train_step(model, opt, criterion_of(name))(
        b["inputs"], b["targets"])
    return {"metrics": dict(zip(keys, packed.tolist())), "grads": grads,
            "masters": {k: _whole(v) for k, v in
                        opt.model_state_dict(model).items()}}


def placed_steps(rank: int, n: int, cfg: Dict) -> Dict:
    """cfg: {"root", "config_path", "cases": {tag: (name, state, batch,
    kw)}}: one ``fit`` step of each case's Trainer (``kw``: the Trainer's
    arguments, and "sp" for a mesh with that sp axis; the models of
    ``PLACED_TINY``'s sizes). Reports its metrics, the gradients the update
    is given and the float32 masters after it (the checkpoint's model
    state), whole; the checkpoint's directory; the dtype of each parameter
    and whether it is placed, and each master's."""
    from aloception_tpu_torch.parallel import make_mesh
    from aloception_tpu_torch.train import experiment
    experiment.CONFIG_PATH = cfg["config_path"]
    out = {}
    for tag, (name, state, batch, kw) in cfg["cases"].items():
        kw = dict(kw)
        sp = kw.pop("sp", None)
        if sp:
            kw["mesh"] = make_mesh(sp=sp)
        cap = Capture()
        trainer = make_trainer(name, state, batch, cfg["root"], run_id=tag,
                               callback=cap, tiny=PLACED_TINY, **kw)
        opt = trainer.optimizer
        grads = capture_gradients(opt, trainer.model)
        trainer.fit([None], max_steps=1)
        out[tag] = {
            "metrics": cap.metrics[0], "grads": grads,
            "masters": {k: _whole(v) for k, v in
                        trainer.state_dict()["model"].items()},
            "ckpt_dir": trainer.ckpt_dir,
            "params": {k: (str(p.dtype), hasattr(p, "_local_tensor"))
                       for k, p in trainer.model.named_parameters()},
            "master_kinds": sorted({(str(m.dtype), hasattr(
                m, "_local_tensor")) for m in opt.masters})}
    return out


def lower_precision_steps(rank: int, n: int, how: str, root: str) -> Dict:
    """``train_on_coco --bf16 --tp 2`` (its tiny DETR at ``PLACED_TINY``'s
    feed-forward width, so that the tp rule places its feed-forward
    Linears; --fast_dev_run: its validation loss) or a Trainer under FSDP
    in bfloat16 (``PLACED_TINY``'s DETR, two steps: their losses), on this
    rank: the steps taken, the losses, the parameters' dtypes, whether any
    is placed, and the (dtype, placed) kinds of the optimizer's masters."""
    import os
    from unittest import mock
    from aloception_tpu_torch.train import experiment
    experiment.CONFIG_PATH = os.path.join(root, "config.json")
    log_dir = os.path.join(root, "expe")
    if how.startswith("train_on_coco"):
        from aloception_tpu_torch.commands import train_on_coco
        from aloception_tpu_torch.models import detr
        Detr, wide = detr.Detr, PLACED_TINY["dim_feedforward"]
        with mock.patch.object(detr, "Detr", lambda **kw: Detr(
                **dict(kw, dim_feedforward=wide))):
            trainer = train_on_coco.main([
                "--cpu", "--sample", "--tiny", "--bf16", "--tp", "2",
                "--multihost", "--fast_dev_run", "--size", "64", "96",
                "--log_dir", log_dir])
        losses = [trainer.last_val_metrics["val_loss_total"]]
    else:
        from aloception_tpu_torch.parallel.dryrun import detr_batch
        from aloception_tpu_torch.train import Trainer
        cap = Capture()
        batch = detr_batch(2, hw=(64, 96))
        labels = batch["targets"]["labels"]
        labels.remainder_(PLACED_TINY["num_classes"])
        trainer = Trainer(build("detr", PLACED_TINY), criterion_of("detr"),
                          prepare_batch=lambda raw, training=True: batch,
                          callbacks=[cap], log_dir=log_dir, fsdp=True,
                          dtype=torch.bfloat16)
        trainer.fit([None] * 2, max_steps=2)
        losses = [m["loss_total"] for m in cap.metrics]
    return {"step": trainer.global_step, "losses": losses,
            "dtypes": sorted({str(p.dtype)
                              for p in trainer.model.parameters()}),
            "placed": any(hasattr(p, "_local_tensor")
                          for p in trainer.model.parameters()),
            "master_kinds": sorted({(str(m.dtype), hasattr(
                m, "_local_tensor")) for m in trainer.optimizer.masters})}


PIPELINES = ((2, 2), (4, 4))     # (pp, microbatches)


def pipelines(rank: int, n: int, stack: Dict, inputs: Dict, dims) -> Dict:
    """``parallel.dryrun.pipeline_pass`` at each of ``PIPELINES``."""
    from aloception_tpu_torch.parallel.dryrun import pipeline_pass
    return {cfg: pipeline_pass(rank, n, *cfg, stack=stack, inputs=inputs,
                               dims=dims) for cfg in PIPELINES}
