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
batch. The JAX package's mesh, tensor parallelism, FSDP and scan-blocked
dispatch are not ported (ROADMAP A12; the blocked dispatch was a TPU
workaround).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

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
        self.optimizer = optimizer if optimizer is not None else \
            TrainOptimizer(model, lr=lr, lr_backbone=lr_backbone,
                           weight_decay=weight_decay, grad_clip=grad_clip,
                           accumulate_steps=accumulate_grad_batches,
                           dtype=dtype)
        self.train_step = make_train_step(model, self.optimizer, criterion,
                                          forward_kwargs)
        self.eval_step = make_eval_step(model, criterion, forward_kwargs)
        self.expe_name, self.run_id, self.ckpt_dir = get_expe_infos(
            project, expe_name, log_dir=log_dir, run_id=run_id)
        self.logger = make_logger(log, self.ckpt_dir)
        self.ckpt = CheckpointManager(self.ckpt_dir, monitor=monitor,
                                      mode=monitor_mode, save_top_k=save_top_k)
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

    def state_dict(self) -> Dict:
        """What a checkpoint holds: model (its float32 masters where it
        trains in a lower precision), optimizer, step and the CPU and card
        generators' states."""
        cuda = torch.cuda.get_rng_state_all() \
            if self.device.type == "cuda" else None
        return {"model": self.optimizer.model_state_dict(self.model),
                "optimizer": self.optimizer.state_dict(),
                "step": self.global_step,
                "rng": {"cpu": torch.get_rng_state(), "cuda": cuda}}

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
                inputs = to_device(prepared["inputs"], self.device)
                targets = to_device(prepared["targets"], self.device)
                keys, packed = self.train_step(inputs, targets)
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
