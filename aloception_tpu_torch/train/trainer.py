"""The generic training loop (counterpart of
``aloception_tpu/train/trainer.py``, the ``run_pl_training`` analog).

A Trainer owns the model and its criterion (one train step and one eval
step), the optimizer, checkpointing (best and last by a monitored metric),
logging and the callbacks. ``fit`` runs epochs of the train loader with
periodic validation. The model trains on the device its parameters are on;
a batch's ``inputs`` are the model's positional arguments, so one Trainer
serves the detectors, the panoptic head and RAFT. Its factories may hand it
a prebuilt ``optimizer`` (a frozen detector, a schedule), the forward's
keyword arguments (RAFT's ``iters``) and the ``inference_fn`` that the AP
and PQ callbacks call on validation outputs. With ``dtype`` bfloat16 the
model computes in bfloat16 over float32 masters (``TrainOptimizer``); the
criterion always computes in float32. The logger (``log``) writes into the
run's checkpoint directory, as the JAX package's does.

Each train batch is prepared on the host, copied to the card by
non-blocking copies from pinned memory, stepped, and its metrics come back
in ONE transfer: that fetch is the only host synchronisation of a train
batch.

Under a process group (``parallel.init_multihost``) the Trainer takes the
JAX Trainer's ``mesh``, ``tp`` and ``fsdp`` (the mesh defaults to
``parallel.make_mesh(tp=tp)``): every rank prepares the same global batch
(same seed) and steps its dp rows (``shard_batch``) inside ``use_mesh``, so
that the criteria's counts, RAFT's BatchNorm and the encoders' sequence
split see the mesh. The model is wrapped in DDP over the dp x sp ranks, or,
with tp > 1 or ``fsdp``, placed by ``partition_params`` (column-parallel
DTensors, ``fully_shard``) with the remaining gradients averaged by
``sync_gradients``; the optimizer is then built over the placed parameters,
so that its moments are placed as they are, and the norm that clips is the
global gradient's (a lower-precision ``dtype`` under tp or FSDP raises
NotImplementedError). The packed metrics are averaged over the ranks before
their one transfer. Validation runs the whole batch on every rank, outside
the mesh, on the unwrapped model. Checkpoints (whole tensors, loadable at
any world size), the run's directory and the logger's event file are
written by rank 0 alone. The JAX package's scan-blocked dispatch
(``steps_per_dispatch``) is not ported: it was a TPU workaround.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.distributed import broadcast_object, is_main_process
from ..parallel.mesh import data_group, make_mesh, mesh_shape, use_mesh
from ..parallel.shard import (data_parallel, full_tensors, shard_batch,
                              sync_gradients)
from .callbacks import Callback, MetricsCallback
from .checkpoint import CheckpointManager
from .experiment import get_expe_infos
from .logger import make_logger
from .state import TrainOptimizer
from .step import make_eval_step, make_train_step


def to_device(tree, device: torch.device):
    """Tensors of a nested dict/tuple/list on ``device``: on a card by a
    non-blocking copy from pinned memory, which does not drain the stream."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if not isinstance(tree, torch.Tensor) or tree.device == device:
        return tree
    if device.type == "cuda":
        return tree.pin_memory().to(device, non_blocking=True)
    return tree.to(device)


class Trainer:

    def __init__(self, model: nn.Module, criterion: Callable,
                 prepare_batch: Callable,
                 inference_fn: Optional[Callable] = None,
                 mesh=None, tp: Optional[int] = None, fsdp: bool = False,
                 optimizer: Optional[TrainOptimizer] = None,
                 forward_kwargs: Optional[Dict] = None,
                 lr: float = 1e-4, lr_backbone: float = 1e-5,
                 weight_decay: float = 1e-4, grad_clip: float = 0.1,
                 accumulate_grad_batches: int = 1,
                 project: str = "default", expe_name: str = "run",
                 log: Optional[str] = None, log_dir: Optional[str] = None,
                 run_id: Optional[str] = None,
                 monitor: str = "val_loss_total", monitor_mode: str = "min",
                 save_top_k: int = 1,
                 callbacks: Optional[List[Callback]] = None,
                 val_check_interval: Optional[int] = None,
                 limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32):
        self.model = model
        self.device = next(model.parameters()).device
        self.prepare_batch = prepare_batch
        self.inference_fn = inference_fn
        tp_size = mesh_shape(mesh)["tp"] if mesh is not None else tp or 1
        placed = tp_size > 1 or fsdp
        train_dtype = optimizer.config["dtype"] if optimizer is not None \
            else dtype
        if placed and train_dtype != torch.float32:
            raise NotImplementedError(
                "tensor parallelism or FSDP with a lower-precision model: "
                "the masters would be taken from its cast")
        self.mesh = mesh if mesh is not None else make_mesh(tp=tp)
        # DDP, or the parameters whose gradients sync_gradients averages
        forward, self._sync = data_parallel(model, self.mesh, fsdp)
        if placed and optimizer is not None:
            # the placement replaced the parameters it was built over
            optimizer = TrainOptimizer(model, **optimizer.config)
        self.forward_model = forward
        self.optimizer = optimizer if optimizer is not None else \
            TrainOptimizer(model, lr=lr, lr_backbone=lr_backbone,
                           weight_decay=weight_decay, grad_clip=grad_clip,
                           accumulate_steps=accumulate_grad_batches,
                           dtype=dtype)
        step = make_train_step(
            forward, self.optimizer, criterion, forward_kwargs,
            after_backward=None if self._sync is None
            else self._after_backward)

        def train_step(inputs, targets):
            with use_mesh(self.mesh):
                return step(inputs, targets)

        self.train_step = train_step
        self.eval_step = make_eval_step(model, criterion, forward_kwargs)
        infos = get_expe_infos(project, expe_name, log_dir=log_dir,
                               run_id=run_id) if is_main_process() else None
        self.expe_name, self.run_id, self.ckpt_dir = broadcast_object(infos)
        self.logger = make_logger(log if is_main_process() else None,
                                  self.ckpt_dir)
        self.ckpt = CheckpointManager(self.ckpt_dir, monitor=monitor,
                                      mode=monitor_mode, save_top_k=save_top_k,
                                      write=is_main_process())
        self.callbacks = callbacks if callbacks is not None \
            else [MetricsCallback()]
        self.val_check_interval = val_check_interval
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        # dropout draws from the default generators of the CPU and the card
        torch.manual_seed(seed)
        self.global_step = 0
        self.last_val_metrics: Dict[str, float] = {}
        self._last_val_step = 0

    def _after_backward(self):
        sync_gradients(self._sync, data_group(self.mesh))

    def state_dict(self) -> Dict:
        """What a checkpoint holds: model (its float32 masters where it
        trains in a lower precision), optimizer, step and the CPU and card
        generators' states; whole tensors where the parameters are placed
        (every rank takes part in gathering them)."""
        cuda = torch.cuda.get_rng_state_all() \
            if self.device.type == "cuda" else None
        return full_tensors({
            "model": self.optimizer.model_state_dict(self.model),
            "optimizer": self.optimizer.state_dict(),
            "step": self.global_step,
            "rng": {"cpu": torch.get_rng_state(), "cuda": cuda}})

    def resume(self) -> bool:
        """Restore the last checkpoint of this run, if there is one."""
        try:
            self.global_step = self.ckpt.restore(self.model, self.optimizer)
        except FileNotFoundError:
            return False
        self._last_val_step = self.global_step
        print(f"[trainer] resumed from step {self.global_step}")
        return True

    def fit(self, train_loader, val_loader=None, max_epochs: int = 1,
            max_steps: Optional[int] = None, resume: bool = False
            ) -> nn.Module:
        if resume:
            self.resume()
        for epoch in range(max_epochs):
            for i, raw in enumerate(train_loader):
                if self.limit_train_batches and i >= self.limit_train_batches:
                    break
                prepared = self.prepare_batch(raw)
                inputs = to_device(shard_batch(prepared["inputs"], self.mesh),
                                   self.device)
                targets = to_device(
                    shard_batch(prepared["targets"], self.mesh), self.device)
                keys, packed = self.train_step(inputs, targets)
                if self.mesh is not None:
                    # each rank's share averages to the global batch's
                    dist.all_reduce(packed)
                    packed = packed / dist.get_world_size()
                self.global_step += 1
                # the batch's one host synchronisation
                metrics = dict(zip(keys, packed.cpu().tolist()))
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, metrics, self.global_step)
                if max_steps and self.global_step >= max_steps:
                    break
                if (self.val_check_interval and val_loader is not None
                        and self.global_step // self.val_check_interval
                        > self._last_val_step // self.val_check_interval):
                    self._last_val_step = self.global_step
                    self.validate(val_loader)
            if val_loader is not None:
                self.validate(val_loader)
            self.ckpt.save(self.global_step, self.state_dict(),
                           metrics=self.last_val_metrics)
            if self.mesh is not None:
                # no rank reads the run's directory before rank 0 wrote it
                dist.barrier()
            for cb in self.callbacks:
                cb.on_epoch_end(self, epoch)
            if max_steps and self.global_step >= max_steps:
                break
        self.logger.flush()
        return self.model

    def validate(self, val_loader) -> Dict[str, float]:
        for i, raw in enumerate(val_loader):
            if self.limit_val_batches and i >= self.limit_val_batches:
                break
            prepared = self.prepare_batch(raw, training=False)
            inputs = to_device(prepared["inputs"], self.device)
            targets = to_device(prepared["targets"], self.device)
            outputs, keys, packed = self.eval_step(inputs, targets)
            metrics = dict(zip(keys, packed.cpu().tolist()))
            for cb in self.callbacks:
                cb.on_val_batch_end(self, outputs, prepared, metrics)
        for cb in self.callbacks:
            cb.on_val_epoch_end(self, self.global_step)
        return self.last_val_metrics
