"""Checkpointing with best/last/monitor semantics on ``torch.save``
(counterpart of ``aloception_tpu/train/checkpoint.py``).

Layout: ``<ckpt_dir>/<step>/checkpoint.pt`` plus a ``registry.json`` that
records each save's monitored metrics, so "best" resolves from the registry.
A checkpoint is a dict: {"model": state_dict, "optimizer": its state,
"step": int, "rng": the CPU and CUDA generator states}; the model's entry
holds float32 masters where it trained in bfloat16, so that it loads into a
model of either precision, and its tensors are whole ones, so that it
loads into a run of any world size. Under a process group only rank 0
writes (``write``); every rank reads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.shard import load_full_state_dict

FILE = "checkpoint.pt"


class CheckpointManager:

    def __init__(self, ckpt_dir: str, monitor: str = "val_loss",
                 mode: str = "min", save_top_k: int = 1,
                 save_last: bool = True, write: bool = True):
        """``write`` False: ``save`` writes nothing and nothing is created
        (the ranks of a process group other than 0)."""
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.write = write
        if write:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self._registry_path = os.path.join(self.ckpt_dir, "registry.json")
        self._registry: Dict[str, Dict] = self._load_registry()

    def _load_registry(self) -> Dict:
        if os.path.exists(self._registry_path):
            with open(self._registry_path) as f:
                return json.load(f)
        return {}

    def _save_registry(self):
        with open(self._registry_path, "w") as f:
            json.dump(self._registry, f, indent=2)

    def save(self, step: int, state: Any, metrics: Optional[Dict] = None):
        """Save ``state`` (any object ``torch.save`` takes; tensors are moved
        to the CPU first) and prune beyond save_top_k by the monitor."""
        if not self.write:
            return
        path = os.path.join(self.ckpt_dir, str(step))
        os.makedirs(path, exist_ok=True)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        tmp = os.path.join(path, FILE + ".tmp")
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, os.path.join(path, FILE))
        self._registry[str(step)] = metrics
        self._save_registry()
        self._prune()

    def _monitored(self, step: str) -> float:
        v = self._registry.get(step, {}).get(self.monitor)
        if v is None:
            return np.inf if self.mode == "min" else -np.inf
        return v

    def _prune(self):
        steps = sorted(self._registry, key=int)
        if len(steps) <= self.save_top_k + (1 if self.save_last else 0):
            return
        last = steps[-1]
        candidates = steps[:-1] if self.save_last else steps
        ranked = sorted(candidates, key=self._monitored,
                        reverse=(self.mode == "max"))
        keep = set(ranked[:self.save_top_k]) | ({last} if self.save_last
                                                else set())
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.ckpt_dir, s),
                              ignore_errors=True)
                self._registry.pop(s, None)
        self._save_registry()

    def best_step(self) -> Optional[int]:
        if not self._registry:
            return None
        ranked = sorted(self._registry, key=self._monitored,
                        reverse=(self.mode == "max"))
        return int(ranked[0])

    def last_step(self) -> Optional[int]:
        steps = [int(s) for s in self._registry]
        return max(steps) if steps else None

    def _path(self, step: Optional[int], best: bool) -> str:
        if step is None:
            step = self.best_step() if best else self.last_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        return os.path.join(self.ckpt_dir, str(step), FILE)

    def restore_tree(self, step: Optional[int] = None,
                     best: bool = False) -> Any:
        """The raw saved object (on the CPU), with no model or optimizer
        needed: for consumers that only need the weights."""
        return torch.load(self._path(step, best), map_location="cpu",
                          weights_only=False)

    def restore(self, model: torch.nn.Module, optimizer=None,
                step: Optional[int] = None, best: bool = False) -> int:
        """Load a checkpoint saved from a trainer into ``model`` and
        ``optimizer`` (when given) and set the CPU and CUDA generators to
        its states. Returns the saved step."""
        tree = self.restore_tree(step, best)
        # whole tensors: a placed parameter (tp, FSDP) takes its shard
        load_full_state_dict(model, tree["model"])
        if optimizer is not None and "optimizer" in tree:
            optimizer.load_state_dict(tree["optimizer"])
            # a model in a lower precision resumes from the float32 masters
            optimizer.load_masters(tree["model"])
        rng = tree.get("rng") or {}
        if "cpu" in rng:
            torch.set_rng_state(rng["cpu"])
        if rng.get("cuda") is not None and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(rng["cuda"])
        return int(tree["step"])


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree
