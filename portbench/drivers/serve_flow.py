"""Serving optical flow in batches of frame pairs: one client, a closed
loop, one batch in flight. Each batch is ``batch_size`` pairs of uint8
(H, W, 3) frames on the card, carried down the program's flow path as
``commands/eval_on_sintel.py`` takes a pair, batched: each side's frames
``Frame`` -> ``norm_minmax_sym`` -> ``batch_list``, then ``Padder`` (to a
multiple of 8) -> RAFT with ``only_last`` -> ``unpad`` -> its
``inference`` -> every ``Flow`` on the host. A batch's latency runs from
the frames handed in to every flow on the host; the window's images per
second count every pair whose flow reached the host in it.

The traffic: each pair's second frame is its first shifted by a seeded
whole-pixel (dx, dy) in [-shift_max, shift_max], the uncovered border
drawn fresh, with uniform noise of +-``noise`` levels, so that the volume
holds a true match; a pool of ``pool_batches`` batches made on the card
from the seed and cycled.

With ``--trace 1`` the window is followed by a device-only trace of
``trace_batches`` batches (idle share), then a trace with host ops over
as many, in which the program's ``alo.*`` spans and its lookup counter
(``CorrPyramid.lookups``) are read.

``correct``: a sample of the window's batches, drawn from the seed, is run
again through the plain float32 reference on the same weights and frames,
and the served flow is held against it."""

from __future__ import annotations

import contextlib
import importlib
import random
import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness, program
from portbench.reference import profiling
from portbench.reference.compare import worst
from portbench.reference.compare_flow import flow_numbers
from portbench.reference.nn import Precision
from portbench.reference.raft_counting import flops_per_pair
from portbench.reference.weights import make_weights

#: The program's spans named in the breakdown's idle gaps.
LABELS = ("alo.frame.init", "alo.spatial.batch_list", "alo.raft.encoders",
          "alo.raft.corr", "alo.raft.lookup", "alo.raft.update",
          "alo.raft.upsample", "alo.model.inference")

Pair = Tuple[List[torch.Tensor], List[torch.Tensor]]


def flow_pool(traffic: Dict, seed: int, device) -> List[Pair]:
    """``pool_batches`` batches of ``batch_size`` pairs, each side a list of
    uint8 (H, W, 3) frames on ``device``. A pair is cut from one canvas
    drawn on the device: the first frame in its middle, the second shifted
    by the pair's (dx, dy) (so the pixel at (x, y) of the first is at
    (x + dx, y + dy) in the second), plus the noise."""
    B, (H, W) = traffic["batch_size"], traffic["frame_hw"]
    S, noise = traffic["shift_max"], traffic["noise"]
    n = traffic["pool_batches"] * B
    shifts = np.random.default_rng(int(seed) % 2**63).integers(
        -S, S + 1, size=(n, 2))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    canvas = torch.randint(0, 256, (n, H + 2 * S, W + 2 * S, 3),
                           device=device, generator=g, dtype=torch.uint8)
    jitter = torch.randint(-noise, noise + 1, (n, H, W, 3), device=device,
                           generator=g, dtype=torch.int16)
    firsts, seconds = [], []
    for i, (dx, dy) in enumerate(shifts.tolist()):
        firsts.append(canvas[i, S:S + H, S:S + W].clone())
        moved = canvas[i, S - dy:S - dy + H, S - dx:S - dx + W]
        seconds.append((moved.short() + jitter[i]).clamp(0, 255)
                       .to(torch.uint8))
    return [(firsts[j:j + B], seconds[j:j + B]) for j in range(0, n, B)]


@contextlib.contextmanager
def timed_conv_algorithms():
    """cuDNN choosing each convolution's algorithm by timing them, restored
    afterwards. With TF32 off its heuristics take FFT convolutions for some
    of the reference's float32 shapes: 11-13 s a batch of 8 Sintel pairs on
    an H100, 88 % of it in one small complex GEMM a frequency."""
    old = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = old


class Driver:

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.t = cell.config, cell.traffic
        self.seed, self.device = seed, device
        self.arch = importlib.import_module(
            f"portbench.reference.models.{self.cfg['architecture']}")
        self.control = cell.control
        self.samples: List[Dict] = []

    # the program's side -------------------------------------------------
    def setup(self):
        from aloception_tpu_torch.aloscene import Frame, batch_list
        self.Frame, self.batch_list = Frame, batch_list
        harness.setup_mark("program imported")
        self.dtype = getattr(torch, self.t["dtype"])
        self.weights = make_weights(self.arch.param_specs(self.cfg),
                                    self.seed, self.dtype, self.device)
        self.model = program.build_model(self.cfg, self.weights, self.dtype,
                                         self.device, self.arch)
        harness.setup_mark("weights and model")
        self.Padder = program.entry(self.cfg["program"]["padder"])
        self.infer = program.entry(self.cfg["program"]["inference"])
        self.pool = flow_pool(self.t, self.seed, self.device)
        harness.setup_mark("frame pool")
        for pair in self.pool:              # every shape the traffic uses
            self.request(pair)
        harness.setup_mark("warm-up")

    def request(self, pair: Pair):
        """One batch down the served path: every pair's ``Flow`` on the
        host."""
        with torch.inference_mode():
            f1, f2 = (self.batch_list(
                [self.Frame(x, names=("H", "W", "C")).norm_minmax_sym()
                 for x in frames]).as_layout(("B", "C", "H", "W"))
                for frames in pair)
            padder = self.Padder(f1.shape, mode="sintel")
            flow = padder.unpad(self.model(*padder.pad(f1, f2),
                                           iters=self.t["iters"],
                                           only_last=True))
            return [f.cpu() for f in self.infer(flow)]

    def measure(self, seconds: float, trace: bool) -> Dict:
        B = self.t["batch_size"]
        pick = random.Random(self.seed)
        k_max = self.t["check_batches"]
        latencies = []
        n = 0
        start = harness.now()
        while True:
            i = n % len(self.pool)
            t = harness.now()
            flows = self.request(self.pool[i])
            done = harness.now()
            latencies.append(done - t)
            keep = len(self.samples) < k_max
            slot = len(self.samples) if keep else pick.randrange(n + 1)
            if slot < k_max:
                sample = {"pool": i,
                          "served": torch.stack([f.array for f in flows])}
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
            run["readings"] = self.traced(n, B, elapsed)
        return run

    def _lookups(self) -> Optional[int]:
        """The program's count of correlation lookups, where it keeps one."""
        from aloception_tpu_torch.ops.correlation import CorrPyramid
        return getattr(CorrPyramid, "lookups", None)

    def traced(self, n, B, elapsed) -> Dict:
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        k = self.t["trace_batches"]
        batches = [self.pool[j % len(self.pool)] for j in range(k)]
        r = {"window": {"seconds": elapsed, "units": n, "images": n * B},
             "device_busy": None}
        if cuda:
            it = iter(batches)
            prof = profiling.trace(lambda: self.request(next(it)),
                                   [ProfilerActivity.CUDA], k)
            r["device_busy"] = profiling.device_busy(prof)
        before = self._lookups()
        it = iter(batches)
        if cuda:
            prof = profiling.trace(
                lambda: self.request(next(it)),
                [ProfilerActivity.CPU, ProfilerActivity.CUDA], k)
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(k):
                    self.request(next(it))
        after = self._lookups()
        hw8 = tuple(s // 8 for s in self.arch.padded_hw(self.t["frame_hw"]))
        r.update(host_trace=prof, n_host_traced=k,
                 raft_lookups=None if before is None else after - before,
                 lookup_shape={"B": B, "hw8": hw8,
                               "levels": self.cfg["corr_levels"],
                               "radius": self.cfg["corr_radius"],
                               "dtype": self.dtype})
        r["breakdown"] = profiling.breakdown(prof, LABELS) if cuda else None
        return r

    def release(self):
        """Free the program's state; the samples, frames and weights
        stay."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the reference's side -----------------------------------------------
    def flops_per_image(self) -> int:
        return flops_per_pair(self.cfg, self.t["frame_hw"],
                              self.t["iters"])

    def _reference(self, pool_index: int, precision: str) -> torch.Tensor:
        w = {k: v.float() for k, v in self.weights.items()}
        f1, f2 = (torch.stack(side) for side in self.pool[pool_index])
        P = Precision(precision, self.device)
        with torch.no_grad(), timed_conv_algorithms(), P.matmuls():
            return self.arch.flows(w, f1, f2, self.cfg, P, self.t["iters"])

    def numbers(self, side: str = "program") -> Dict[str, float]:
        """The compared numbers, worst over the sampled batches: of the
        served flow (``program``), or of the reference computed in the
        precision below the cell's put in the program's place
        (``control``)."""
        readings = []
        for s in self.samples:
            ref = self._reference(s["pool"], "float32")
            got = s["served"] if side == "program" \
                else self._reference(s["pool"], self.control)
            readings.append(flow_numbers(ref, got))
        return worst(readings)
