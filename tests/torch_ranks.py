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


def build(name: str):
    from aloception_tpu_torch.models import deformable_detr, detr, raft
    if name == "detr":
        return detr.Detr(device="cpu", **DETR_TINY)
    if name == "deformable":
        return deformable_detr.DeformableDETR(with_box_refine=True,
                                              device="cpu", **DETR_TINY)
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
                 run_id: str, callback: Capture, log=None, **kw):
    """A Trainer of model ``name`` loaded with ``state`` (numpy), whose
    every batch is ``batch`` (numpy, global), writing under ``root``."""
    from aloception_tpu_torch.train import Trainer
    model = build(name)
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


PIPELINES = ((2, 2), (4, 4))     # (pp, microbatches)


def pipelines(rank: int, n: int, stack: Dict, inputs: Dict, dims) -> Dict:
    """``parallel.dryrun.pipeline_pass`` at each of ``PIPELINES``."""
    from aloception_tpu_torch.parallel.dryrun import pipeline_pass
    return {cfg: pipeline_pass(rank, n, *cfg, stack=stack, inputs=inputs,
                               dims=dims) for cfg in PIPELINES}
