"""Training through the program's ``Trainer.fit``: the configuration's
trainer factory over the benchmark's model, its data module's
``prepare_batch`` at the traffic's fixed size, on raw batches (normalised
frames with COCO-like boxes and classes) made from the seed in set-up and
cycled, so that every step runs ``prepare_batch``, ``to_device``,
``train_step`` and the one metrics fetch.

One ``fit`` call does it all, fed by a loader that first hands it the
``setup_steps`` set-up steps (the same call and feed as the window's, on
batches that all differ; the optimizer's state after the first and the
parameters after the last are read for the check), then the window, which
opens after the last set-up step's fetch and closes at the fetch of the
first step to end past ``seconds``; with ``--trace 1`` then a device-only
trace of ``trace_steps`` steps and one with host ops and the benchmark's
labels. ``fit``'s end-of-epoch checkpoint is written after all of them,
under ``TMPDIR``, which the run removes.

``correct``: the plain float32 reference takes the set-up steps from the
same weights on the same batches; the losses, the first gradient as the
optimizer took it and the parameters' change are held against it."""

from __future__ import annotations

import contextlib
import importlib
import shutil
import tempfile
from typing import Dict, List
from unittest import mock

import torch

from portbench import harness, inputs, program
from portbench.reference import counting, profiling
from portbench.reference.compare import train_numbers
from portbench.reference.frames import RESNET_MEAN, RESNET_STD
from portbench.reference.nn import Precision
from portbench.reference.train import train_steps
from portbench.reference.weights import make_weights

LABELS = ("prepare_batch", "to_device", "train_step")


class Recorder:
    """A ``Trainer`` callback: each step's metrics, and at the steps
    named the norms the check reads (``reads``: step -> function)."""

    def __init__(self, reads):
        self.losses: List[float] = []
        self.reads = reads

    def on_train_batch_end(self, trainer, metrics, step):
        self.losses.append(metrics["loss_total"])
        if step in self.reads:
            self.reads[step](trainer)

    def __getattr__(self, name):            # the other callback hooks
        if name.startswith("on_"):
            return lambda *args, **kwargs: None
        raise AttributeError(name)


class Driver:

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.t = cell.config, cell.traffic
        self.seed, self.device = seed, device
        self.arch = importlib.import_module(
            f"portbench.reference.models.{self.cfg['architecture']}")
        self.control = cell.control
        self.prog_norms: Dict = {}

    # the program's side -------------------------------------------------
    def setup(self):
        from aloception_tpu_torch.aloscene import BoundingBoxes2D, Frame, \
            Labels
        from aloception_tpu_torch.train import CocoDetection2Detr
        harness.setup_mark("program imported")
        torch.backends.cuda.matmul.allow_tf32 = self.t["tf32"]
        torch.backends.cudnn.allow_tf32 = self.t["tf32"]
        dtype = getattr(torch, self.t["dtype"])
        self.weights = make_weights(self.arch.param_specs(self.cfg),
                                    self.seed, torch.float32, self.device)
        model = program.build_model(self.cfg, self.weights, torch.float32,
                                    self.device, self.arch)
        harness.setup_mark("weights and model")
        self.pool = inputs.train_pool(self.t, self.seed, self.device)
        self.raw = [[Frame(it["pixels"], boxes2d=BoundingBoxes2D(
            it["boxes"], boxes_format="xcyc", absolute=False,
            labels=Labels(it["labels"].float()))).norm_resnet()
            for it in batch] for batch in self.pool]
        dm = CocoDetection2Detr(batch_size=self.t["batch_size"], sample=True,
                                size=tuple(self.t["image_size"]))
        self.log_dir = tempfile.mkdtemp(prefix="portbench_")
        self.names = {}
        aliases = self.arch.aliases(self.cfg)
        for name, p in model.named_parameters():
            self.names[id(p)] = aliases.get(name, name)
        last = self.t["setup_steps"]
        self.recorder = Recorder({1: self._read_grads, last: self._read_change})
        from aloception_tpu_torch.train.callbacks import MetricsCallback
        self.trainer = program.entry(self.cfg["program"]["trainer"])(
            model=model, data_module=dm, log_dir=self.log_dir,
            callbacks=[MetricsCallback(), self.recorder], seed=self.seed,
            dtype=dtype)
        harness.setup_mark("pool and trainer")

    def _leaf_norms(self, tensors: Dict[str, torch.Tensor]) -> Dict:
        names = list(tensors)
        norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                             for k in names]).cpu().tolist()
        return dict(zip(names, norms))

    def _read_grads(self, trainer):
        """The first gradient as the optimizer took it: AdamW's first
        moment after one step is (1 - beta1) times it (nought where the
        optimizer keeps no state of a parameter)."""
        opt = trainer.optimizer.adamw
        moments = {}
        for group in opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                m = opt.state[p].get("exp_avg", torch.zeros_like(p))
                moments[self.names[id(p)]] = m / (1 - beta1)
        self.prog_norms["grad"] = self._leaf_norms(moments)

    def _read_change(self, trainer):
        model = trainer.model
        self.prog_norms["change"] = self._leaf_norms(
            {self.names[id(p)]: p.detach() - self.weights[self.names[id(p)]]
             for p in model.parameters()})

    def loader(self, seconds: float, trace: bool, run: Dict):
        """What ``fit`` iterates: the set-up steps, the window, the traced
        steps; it keeps the window's times and the readings in ``run``."""
        from torch.profiler import ProfilerActivity
        n = len(self.raw)
        i = 0
        harness.setup_mark("fit entered")
        for _ in range(self.t["setup_steps"]):
            yield self.raw[i % n]
            i += 1
            harness.setup_mark(f"set-up step {i}")
        start = harness.now()
        run["window_start"] = start
        run["unit_s"] = []
        steps = 0
        while True:
            t = harness.now()
            yield self.raw[i % n]
            i += 1
            steps += 1
            done = harness.now()
            run["unit_s"].append(done - t)
            if done - start >= seconds:
                break
        run["window_end"] = done
        run["steps"] = steps
        if not trace:
            return
        k = self.t["trace_steps"]
        cuda = self.device.type == "cuda"
        if cuda:
            from torch.profiler import profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(k):
                    yield self.raw[i % n]
                    i += 1
                torch.cuda.synchronize()
            run["device_busy"] = profiling.device_busy(prof)
        trainer_mod = importlib.import_module(
            type(self.trainer).__module__)
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                self.trainer, "prepare_batch",
                profiling.labelled(self.trainer.prepare_batch,
                                   "prepare_batch")))
            stack.enter_context(mock.patch.object(
                self.trainer, "train_step",
                profiling.labelled(self.trainer.train_step, "train_step")))
            if hasattr(trainer_mod, "to_device"):
                stack.enter_context(mock.patch.object(
                    trainer_mod, "to_device",
                    profiling.labelled(trainer_mod.to_device, "to_device")))
            from torch.profiler import profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            with profile(activities=acts) as prof:
                for _ in range(k):
                    yield self.raw[i % n]
                    i += 1
                if cuda:
                    torch.cuda.synchronize()
        run["host_trace"] = prof

    def measure(self, seconds: float, trace: bool) -> Dict:
        run: Dict = {}
        self.trainer.fit(self.loader(seconds, trace, run), max_epochs=1)
        setup = self.t["setup_steps"]
        elapsed = run["window_end"] - run["window_start"]
        B = self.t["batch_size"]
        window_losses = self.recorder.losses[setup:setup + run["steps"]]
        failed = sum(1 for v in window_losses if v != v
                     or v in (float("inf"), float("-inf")))
        out = {"window_start": run["window_start"],
               "attempted": run["steps"], "failed": failed,
               "unit_s": run["unit_s"],
               "end_to_end": {"train_images_per_s":
                              run["steps"] * B / elapsed}}
        if trace:
            out["readings"] = {
                "window": {"seconds": elapsed, "units": run["steps"],
                           "images": run["steps"] * B},
                "spans": {}, "device_busy": run.get("device_busy"),
                "host_trace": run["host_trace"],
                "n_host_traced": self.t["trace_steps"],
                "breakdown": profiling.breakdown(run["host_trace"], LABELS)
                if self.device.type == "cuda" else None}
        return out

    def release(self):
        """Free the program's state and remove its run directory."""
        del self.trainer
        shutil.rmtree(self.log_dir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the reference's side -----------------------------------------------
    def flops_per_image(self) -> int:
        return counting.forward_flops(self.arch, self.cfg,
                                      self.t["image_size"])

    def batches(self) -> List:
        """The set-up steps' batches as the reference takes them, made
        from the benchmark's own pool."""
        mean = torch.tensor(RESNET_MEAN, device=self.device)
        std = torch.tensor(RESNET_STD, device=self.device)
        cap = min(100, self.cfg["num_queries"])
        out = []
        for k in range(self.t["reference_steps"]):
            items = self.pool[k % len(self.pool)]
            px = torch.stack([it["pixels"] for it in items]).to(self.device)
            images = ((px.permute(0, 2, 3, 1) / 255.0) - mean) / std
            mask = torch.zeros(images.shape[:3], device=self.device)
            B = len(items)
            boxes = torch.zeros(B, cap, 4, device=self.device)
            labels = torch.zeros(B, cap, dtype=torch.long,
                                 device=self.device)
            valid = torch.zeros(B, cap, dtype=torch.bool, device=self.device)
            for b, it in enumerate(items):
                nb = len(it["boxes"])
                boxes[b, :nb] = it["boxes"].to(self.device)
                labels[b, :nb] = it["labels"].to(self.device)
                valid[b, :nb] = True
            out.append((images, mask, {"boxes": boxes, "labels": labels,
                                       "valid": valid}))
        return out

    def reference(self, precision: str) -> Dict:
        return train_steps(self.weights, self.batches(), self.arch, self.cfg,
                           Precision(precision, self.device))

    def numbers(self, side: str = "program") -> Dict[str, float]:
        """The compared numbers of the program's set-up steps
        (``program``), or of the reference computed in the precision below
        the cell's put in the program's place (``control``)."""
        if not hasattr(self, "_ref32"):
            self._ref32 = self.reference("float32")
        n = self.t["reference_steps"]
        if side == "program":
            got = {"losses": self.recorder.losses[:n], **self.prog_norms}
        else:
            got = self.reference(self.control)
        return train_numbers(got, self._ref32)

    def worst_leaves(self, n: int = 3) -> Dict:
        """The leaves with the widest gaps of the program's norms, for a
        look at what a number reads."""
        from portbench.reference.compare import leaf_gaps
        out = {}
        for key in ("grad", "change"):
            gaps = leaf_gaps(self.prog_norms[key], self._ref32[key],
                             sorted(self._ref32[key]))
            out[key] = sorted(((round(v, 6), k) for k, v in gaps.items()),
                              reverse=True)[:n]
        out["loss_steps"] = [abs(p - r) / abs(r) for p, r in zip(
            self.recorder.losses, self._ref32["losses"])]
        return out
