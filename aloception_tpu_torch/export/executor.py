"""Executor: load and run an AOTInductor package (counterpart of
``aloception_tpu/export/executor.py``; reference:
alonet/torch2trt/TRTExecutor.py:36 TRTExecutor and its layer-time
Profiler:13)."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Union

import numpy as np
import torch

# a package that holds the MSDA operator calls it by name: register it
# before loading, so that the package runs without the model code
from ..ops import ms_deform_attn as _msda_op  # noqa: F401
from .base_exporter import ExportArtifact


class Profiler:
    """(TRTExecutor.py:13) accumulate per-call latency."""

    def __init__(self):
        self.times: List[float] = []

    def record(self, dt: float):
        self.times.append(dt)

    def report(self) -> Dict[str, float]:
        t = np.asarray(self.times) if self.times else np.zeros(1)
        return {"mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p99_ms": float(np.percentile(t, 99) * 1e3),
                "calls": len(self.times)}


class Executor:
    """Run an exported package (TRTExecutor.py:36 analog), on the device it
    was compiled for. With ``profiling`` each call is timed by the host
    clock to a synchronised end."""

    def __init__(self, artifact: Union[str, ExportArtifact],
                 profiling: bool = False):
        if isinstance(artifact, str):
            artifact = ExportArtifact.load(artifact)
        self.meta = artifact.meta
        self._runner = torch._inductor.aoti_load_package(
            artifact.package_path)
        self.profiler = Profiler() if profiling else None

    def __call__(self, *inputs):
        if self.profiler is None:
            return self._runner(*inputs)
        t0 = time.perf_counter()
        out = self._runner(*inputs)
        if any(x.is_cuda for x in inputs):
            torch.cuda.synchronize()
        self.profiler.record(time.perf_counter() - t0)
        return out

    def execute(self, inputs: Dict[str, Any]) -> Any:
        """Dict-style call for serving handlers."""
        return self(*inputs.values())
