"""Deployment export pipeline (counterpart of
``aloception_tpu/export/base_exporter.py``).

The reference exports torch -> ONNX -> graph surgery -> TensorRT engine,
with a C++/CUDA plugin for MSDA; the JAX package exports StableHLO. Here the
pipeline is:

    model (eval mode, parameters closed over)
        -> torch.export          (the artifact's program, at fixed shapes)
        -> AOTInductor package   (the ".pt2", the engine build)
        -> sanity check against the eager outputs
        -> Executor / ModelHandler

The MSDA kernel is the registered operator
``aloception_tpu_torch::ms_deform_attn`` (``ops/ms_deform_attn.py``): the
exported graph holds it as one node and the compiled package calls it, so
on the card it runs the hand-written CUDA kernel, the port's analog of the
reference's TensorRT plugin.

Precision profiles: ``fp32``; ``bf16`` (``fp16`` and ``mix`` are aliases)
rounds every floating parameter and buffer through bfloat16 and computes in
float32, as the JAX package's profile does (its models keep
``dtype=float32``, so flax promotes the bf16 parameters back to float32).
"""

from __future__ import annotations

import copy
import functools
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops import ms_deform_attn as _msda_op  # noqa: F401  registers the op

PRECISIONS = ("fp32", "bf16", "fp16", "mix")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat_outputs(outputs) -> List[torch.Tensor]:
    """The tensors of a (nested) output in order: dict values by key order,
    sequences in order."""
    if isinstance(outputs, torch.Tensor):
        return [outputs]
    if isinstance(outputs, dict):
        return [t for v in outputs.values() for t in _flat_outputs(v)]
    return [t for v in outputs for t in _flat_outputs(v)]


class ExportArtifact:
    """An AOTInductor package (``.pt2``) plus a ``.json`` sidecar holding
    ``meta`` and ``input_specs`` (the ``.engine`` analog). ``program`` is
    the ``torch.export.ExportedProgram`` it was compiled from, when it was
    made in this process."""

    def __init__(self, package_path: str, input_specs, meta: Dict,
                 program: Optional[torch.export.ExportedProgram] = None):
        self.package_path = package_path
        self.input_specs = input_specs
        self.meta = meta
        self.program = program

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if os.path.abspath(path) != os.path.abspath(self.package_path):
            shutil.copyfile(self.package_path, path)
            self.package_path = path
        with open(path + ".json", "w") as f:
            json.dump({"meta": self.meta,
                       "input_specs": [list(map(str, s))
                                       for s in self.input_specs]}, f)
        return path

    @classmethod
    def load(cls, path: str) -> "ExportArtifact":
        meta, specs = {}, []
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                j = json.load(f)
            meta, specs = j.get("meta", {}), j.get("input_specs", [])
        return cls(path, specs, meta)


class _Program(nn.Module):
    """``exporter.forward(model, *inputs)`` with ``adapt_outputs`` applied:
    the module that ``torch.export`` traces."""

    def __init__(self, model: nn.Module, forward: Callable,
                 adapt_outputs: Callable):
        super().__init__()
        self.model = model
        self._forward = forward
        self._adapt = adapt_outputs

    def forward(self, *inputs):
        return self._adapt(self._forward(self.model, *inputs))


class BaseExporter:
    """(base_exporter.py:60) Subclasses provide ``example_inputs`` and,
    where the call is not ``model(*inputs)``, ``forward``. The model holds
    its parameters; its device is the package's."""

    def __init__(self, model: nn.Module, precision: str = "fp32",
                 batch_size: int = 1, sanity_atol: float = 1e-2,
                 name: str = "model"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.model = model
        self.precision = precision
        self.batch_size = batch_size
        self.sanity_atol = sanity_atol
        self.name = name
        self.artifact: Optional[ExportArtifact] = None
        self.executor = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # hooks ---------------------------------------------------------------
    def forward(self, model: nn.Module, *inputs):
        return model(*inputs)

    def build_fn(self) -> nn.Module:
        """The module that is exported: the model in eval mode with its
        parameters adapted to the precision profile and closed over (the
        tracing=True analog, detr.py:116), called as ``forward`` does, its
        outputs passed through ``adapt_outputs``."""
        return _Program(self.adapt_params(self.model).eval(), self.forward,
                        self.adapt_outputs)

    def example_inputs(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def adapt_params(self, model: nn.Module) -> nn.Module:
        """Precision adaptation (the adapt_graph analog,
        base_exporter.py:205): ``fp32`` returns the model itself; the other
        profiles a copy whose float32 parameters and buffers are rounded
        through bfloat16 and kept in float32."""
        if self.precision == "fp32":
            return model
        model = copy.deepcopy(model)
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                if t.dtype == torch.float32:
                    t.copy_(t.to(torch.bfloat16))
        return model

    def adapt_outputs(self, outputs):
        """Select/flatten the exported outputs; default passthrough."""
        return outputs

    # pipeline ------------------------------------------------------------
    def export_program(self) -> Tuple[torch.export.ExportedProgram, nn.Module,
                                      Tuple[torch.Tensor, ...]]:
        """``torch.export`` of ``build_fn`` at the example shapes: (the
        exported program, the eager module, the example inputs)."""
        module = self.build_fn()
        inputs = self.example_inputs()
        with torch.no_grad():
            exported = torch.export.export(module, inputs, strict=False)
        return exported, module, inputs

    def export_engine(self, path: Optional[str] = None,
                      sanity_check: bool = True) -> ExportArtifact:
        """(base_exporter.py:410) torch.export, AOTInductor compile, sanity
        check against eager, save. Any failure raises. Prints the seconds of
        the export and of the compile."""
        t0 = time.perf_counter()
        exported, module, inputs = self.export_program()
        t1 = time.perf_counter()
        package = path if path is not None else os.path.join(
            tempfile.mkdtemp(prefix="aloexport_"), f"{self.name}.pt2")
        os.makedirs(os.path.dirname(os.path.abspath(package)), exist_ok=True)
        with torch._inductor.config.patch({"cpp.cxx": (host_compiler(),)}):
            package = torch._inductor.aoti_compile_and_package(
                exported, package_path=package)
        t2 = time.perf_counter()
        print(f"[export] {self.name} ({self.precision}): torch.export "
              f"{t1 - t0:.1f} s, AOTInductor compile {t2 - t1:.1f} s, "
              f"package {os.path.getsize(package) / 2 ** 20:.1f} MiB")
        artifact = ExportArtifact(
            package,
            input_specs=[(tuple(x.shape), _dtype_name(x.dtype))
                         for x in inputs],
            meta={"name": self.name, "precision": self.precision,
                  "device": self.device.type,
                  "export_s": t1 - t0, "compile_s": t2 - t1,
                  "torch": torch.__version__},
            program=exported)
        self.artifact = artifact
        from .executor import Executor
        self.executor = Executor(artifact)
        if sanity_check:
            self.sanity_check(artifact, inputs, module)
        if path is not None:
            artifact.save(path)
        return artifact

    def sanity_check(self, artifact: ExportArtifact, inputs,
                     eager_fn: Callable) -> float:
        """Package against eager outputs (base_exporter.py:370): raises
        AssertionError where an output differs by more than
        ``sanity_atol``. Returns the largest difference."""
        from .executor import Executor
        runner = self.executor if self.executor is not None \
            and self.artifact is artifact else Executor(artifact)
        with torch.no_grad():
            out_e = _flat_outputs(eager_fn(*inputs))
            out_x = _flat_outputs(runner(*inputs))
        worst = 0.0
        for a, b in zip(out_e, out_x):
            diff = (a.float() - b.float()).abs().max().item()
            worst = max(worst, diff)
            if not diff <= self.sanity_atol:
                raise AssertionError(
                    f"sanity check failed: exported vs eager diff {diff} > "
                    f"{self.sanity_atol}")
        artifact.meta["sanity_max_diff"] = worst
        return worst

    def profile(self, n_iters: int = 10) -> Dict[str, float]:
        """Latency and FLOPs (the TRT layer-profiler analog,
        TRTExecutor.py:13), the JAX report's keys: ``latency_ms``, the mean
        over ``n_iters`` calls after 3 warm-up calls of the package (of the
        eager module where nothing was exported), by CUDA events on the
        card and the host clock on the CPU; ``flops`` of one eager forward
        by ``FlopCounterMode`` (the MSDA operator's formula counts its
        multiply-adds); ``tflops_s``."""
        from torch.utils.flop_counter import FlopCounterMode
        module = self.build_fn()
        inputs = self.example_inputs()
        # the counter's module tracker hooks the autograd graph: count with
        # grad enabled (the forward only)
        with torch.enable_grad(), FlopCounterMode(display=False) as counter:
            module(*inputs)
        flops = float(counter.get_total_flops())
        run = self.executor if self.executor is not None else module
        with torch.no_grad():
            latency = _latency_ms(lambda: run(*inputs), n_iters, self.device)
        return {"latency_ms": latency, "flops": flops,
                "tflops_s": flops / (latency / 1e3) / 1e12}


@functools.lru_cache(maxsize=None)
def _links_openmp(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links an OpenMP program, as Inductor's
    build of a package's host code asks of it."""
    with tempfile.TemporaryDirectory(prefix="aloexport_cxx_") as d:
        src = os.path.join(d, "probe.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        try:
            res = subprocess.run([cxx, "-fopenmp", src, "-o",
                                  os.path.join(d, "probe")],
                                 capture_output=True)
        except OSError:          # no such compiler
            return False
    return res.returncode == 0


def host_compiler() -> str:
    """The C++ compiler that builds a package's host code: the one Inductor
    takes by default (``$CXX``, else ``g++``) where it can link OpenMP,
    else the ``g++`` on PATH. A compiler that cannot (a partial toolchain
    named by ``$CXX``, without ``libgomp.spec``) fails Inductor's link; its
    packages, linked without OpenMP, crashed when loaded on the card
    machine. Raises when no candidate can."""
    candidates = [os.environ.get("CXX") or "g++", shutil.which("g++")]
    for cxx in dict.fromkeys(c for c in candidates if c):
        if _links_openmp(cxx):
            return cxx
    raise RuntimeError(f"no C++ compiler among {candidates} links OpenMP; "
                       "AOTInductor cannot build a package's host code")


def _latency_ms(fn: Callable[[], Any], n_iters: int, device: torch.device,
                warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n_iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_iters
    t0 = time.perf_counter()
    for _ in range(n_iters):
        fn()
    return (time.perf_counter() - t0) / n_iters * 1e3
