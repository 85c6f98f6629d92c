"""Serving batches of frames: one client, a closed loop, one batch in
flight. Each batch is ``batch_size`` uint8 frames of mixed sizes from the
host pool, handed to the program on the host and carried down its Frame
path (``Frame`` -> ``norm_resnet`` -> ``resize`` to the longer side ->
``batch_list`` to a fixed size) -> the model -> its ``inference`` -> the
detections on the host. A batch's latency runs from the frames handed in
to the detections on the host; the window's images per second count every
image whose detections reached the host in it.

With ``--trace 1`` the window is followed by a device-only trace of
``trace_batches`` batches (idle share), a trace with host ops and the
benchmark's labels (the frame path, the model, its backbone and
transformer by forward hooks, inference, the copy to the host; the
deformable attention's inputs captured at its call) and one batch under
CUDA's sync-debug mode.

``correct``: a sample of the window's batches, drawn from the seed, is run
again through the plain float32 reference on the same weights and frames,
and its logits, boxes and served detections are held against it."""

from __future__ import annotations

import contextlib
import importlib
import random
import statistics
from typing import Dict, List
from unittest import mock

import torch

from portbench import harness, inputs, program
from portbench.reference import compare, counting, frames as ref_frames, \
    profiling
from portbench.reference.nn import Precision
from portbench.reference.weights import make_weights

LABELS = ("frame path", "model", "backbone", "transformer", "inference",
          "to host")


class Driver:

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.t = cell.config, cell.traffic
        self.seed, self.device = seed, device
        self.arch = importlib.import_module(
            f"portbench.reference.models.{self.cfg['architecture']}")
        self.threshold = self.cfg["program"]["inference_threshold"]
        self.control = cell.control
        self.labelling = False
        self.samples: List[Dict] = []

    # the program's side -------------------------------------------------
    def setup(self):
        from aloception_tpu_torch.aloscene import Frame, batch_list
        self.Frame, self.batch_list = Frame, batch_list
        harness.setup_mark("program imported")
        dtype = getattr(torch, self.t["dtype"])
        self.weights = make_weights(self.arch.param_specs(self.cfg),
                                    self.seed, dtype, self.device)
        self.model = program.build_model(self.cfg, self.weights, dtype,
                                         self.device, self.arch)
        harness.setup_mark("weights and model")
        self.infer = program.entry(self.cfg["program"]["inference"])
        self.pool = inputs.frame_pool(self.t, self.seed, self.device)
        harness.setup_mark("frame pool")
        for frames in self.pool:           # every shape the traffic uses
            self.request(frames)
        harness.setup_mark("warm-up")

    def _label(self, name):
        if self.labelling:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()

    def request(self, frames: List[torch.Tensor]):
        """One batch down the served path: (outputs, detections on the
        host)."""
        long_side, pad_to = self.t["long_side"], tuple(self.t["pad_to"])
        with torch.inference_mode():
            with self._label("frame path"):
                fs = []
                for x in frames:
                    f = self.Frame(x.to(self.device)).norm_resnet()
                    fs.append(f.resize(ref_frames.resized_hw(
                        f.H, f.W, long_side)))
                batch = self.batch_list(fs, size=pad_to)
                images = batch.as_layout(("B", "H", "W", "C"))
                mask = batch.mask.array[:, 0]
            self.t_model = harness.now()
            with self._label("model"):
                out = self.model(images, mask)
            with self._label("inference"):
                dets = self.infer(out, threshold=self.threshold)
            with self._label("to host"):
                dets = [d.cpu() for d in dets]
        return out, dets

    def measure(self, seconds: float, trace: bool) -> Dict:
        B = self.t["batch_size"]
        pick = random.Random(self.seed)
        k_max = self.t["check_batches"]
        spans, latencies = [], []
        n = 0
        start = harness.now()
        while True:
            i = n % len(self.pool)
            t = harness.now()
            out, dets = self.request(self.pool[i])
            done = harness.now()
            latencies.append(done - t)
            spans.append(self.t_model - t)
            keep = len(self.samples) < k_max
            slot = len(self.samples) if keep else pick.randrange(n + 1)
            if slot < k_max:
                sample = {"pool": i, "logits": out["pred_logits"],
                          "boxes": out["pred_boxes"], "served": dets}
                if keep:
                    self.samples.append(sample)
                else:
                    self.samples[slot] = sample
            n += 1
            if done - start >= seconds:
                break
        elapsed = done - start
        p95 = statistics.quantiles(latencies, n=20)[18] \
            if len(latencies) > 1 else latencies[0]
        run = {"window_start": start, "attempted": n, "failed": 0,
               "unit_s": latencies,
               "end_to_end": {"images_per_s": n * B / elapsed,
                              "batch_p95_ms": p95 * 1e3}}
        if trace:
            run["readings"] = self.traced(spans, n, B, elapsed)
        return run

    def traced(self, spans, n, B, elapsed) -> Dict:
        from torch.profiler import ProfilerActivity
        cuda = self.device.type == "cuda"
        k = self.t["trace_batches"]
        batches = [self.pool[j % len(self.pool)] for j in range(k)]
        r = {"window": {"seconds": elapsed, "units": n, "images": n * B},
             "spans": {"frame path": spans}, "device_busy": None}
        it = iter(batches)
        if cuda:
            prof = profiling.trace(lambda: self.request(next(it)),
                                   [ProfilerActivity.CUDA], k)
            r["device_busy"] = profiling.device_busy(prof)
        calls: List = []
        hooks = []

        def enter(label):
            def pre(mod, args):
                rf = self._label(label)
                rf.__enter__()
                mod._portbench_rf = rf
            return pre

        def leave(mod, args, out):
            mod._portbench_rf.__exit__(None, None, None)

        for label in ("backbone", "transformer"):
            mod = getattr(self.model, label, None)
            if isinstance(mod, torch.nn.ModuleList):
                mod = mod[0]
            if mod is not None:
                hooks += [mod.register_forward_pre_hook(enter(label)),
                          mod.register_forward_hook(leave)]
        with contextlib.ExitStack() as stack:
            for src in program.msda_modules(self.model):
                op = src.ms_deform_attn

                def capture(value, shapes, loc, w, _op=op):
                    calls.append((tuple(value.shape), value.element_size(),
                                  [tuple(s) for s in shapes], loc, w))
                    return _op(value, shapes, loc, w)
                stack.enter_context(mock.patch.object(src, "ms_deform_attn",
                                                      capture))
            self.labelling = True
            it = iter(batches)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            if cuda:
                prof = profiling.trace(lambda: self.request(next(it)), acts,
                                       k)
            else:
                from torch.profiler import profile
                with profile(activities=acts) as prof:
                    for _ in range(k):
                        self.request(next(it))
            self.labelling = False
        for h in hooks:
            h.remove()
        r.update(host_trace=prof, n_host_traced=k, msda_calls=calls)
        r["breakdown"] = profiling.breakdown(prof, LABELS) if cuda else None
        caught: List[str] = []
        if cuda:
            with profiling.sync_debug(caught):
                self.request(self.pool[0])
            r["syncs_per_unit"] = len(caught)
        return r

    def release(self):
        """Free the program's state; the samples and weights stay."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the reference's side -----------------------------------------------
    def flops_per_image(self) -> int:
        return counting.forward_flops(self.arch, self.cfg, self.t["pad_to"])

    def _reference(self, pool_index: int, precision: str) -> Dict:
        w = {k: v.float() for k, v in self.weights.items()}
        images, mask = ref_frames.prepare(
            self.pool[pool_index], self.t["long_side"], self.t["pad_to"],
            self.device)
        P = Precision(precision, self.device)
        with torch.no_grad(), P.matmuls():
            out = self.arch.forward(w, images, mask, self.cfg, P)
        return {"pred_logits": out["pred_logits"],
                "pred_boxes": out["pred_boxes"]}

    def numbers(self, side: str = "program") -> Dict[str, float]:
        """The compared numbers, worst over the sampled batches: of the
        program's outputs (``program``), or of the reference computed in
        the precision below the cell's put in the program's place
        (``control``)."""
        readings = []
        for s in self.samples:
            ref = self._reference(s["pool"], "float32")
            if side == "program":
                got = {"logits": s["logits"], "boxes": s["boxes"],
                       "served": [plain(d) for d in s["served"]]}
            else:
                ctrl = self._reference(s["pool"], self.control)
                got = {"logits": ctrl["pred_logits"],
                       "boxes": ctrl["pred_boxes"],
                       "served": compare.served_by(ctrl, self.arch, self.cfg,
                                                   self.threshold)}
            readings.append(compare.serve_numbers(ref, got, self.arch,
                                                  self.cfg, self.threshold))
        return compare.worst(readings)


def plain(dets):
    """A served image's detections as plain tensors (boxes, labels,
    scores)."""
    labels = dets.get_child("labels")
    return dets.array, labels.array, labels.scores
