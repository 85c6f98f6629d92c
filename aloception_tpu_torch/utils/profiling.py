"""Profiling (counterpart of ``aloception_tpu/utils/profiling.py``): a trace
of a block's activity on the host and the card, the program's named spans
inside it, and the cost of a function (operations, bytes, transcendentals)
with its roofline position.

The JAX package traces with ``jax.profiler`` and reads XLA's cost model of
the compiled program. Here ``trace`` runs ``torch.profiler`` and
``cost_analysis`` runs the function once, eagerly, under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode of its own
that counts what every ATen operator reads and writes.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Dict

import torch

# what ``span`` returns when no profiler records: one shared, stateless
# context, so that a span costs a flag check
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
_is_compiling = torch.compiler.is_compiling

# the ATen operators whose every output element counts as a transcendental
TRANSCENDENTAL_OPS = ("exp", "log", "tanh", "sigmoid", "erf", "sin", "cos",
                      "rsqrt")


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(),
                                      "aloception_trace")):
    """Trace the block with ``torch.profiler``: the host's activity, and the
    card's where there is one. On leaving it writes a Chrome-trace file
    (``*.pt.trace.json``, which TensorBoard's profiler plugin and Perfetto
    open) into ``log_dir``. Yields ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def span(name: str):
    """A named range of the program (``alo.<layer>.<part>``) for the block
    it opens: ``torch.profiler.record_function(name)`` while a profiler
    records, so that the range sits on the profiler's clock beside the
    card's kernels and copies (``trace`` writes it into its file), and
    otherwise, or while ``torch.compile`` or ``torch.export`` traces, one
    shared no-op context: a span then costs one flag check and records
    nothing into a graph."""
    if _is_compiling() or not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _bytes_of(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _numel_of(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _counting_mode(counts: Dict[str, float]):
    """A dispatch mode that adds to ``counts`` each operator's input plus
    output bytes ("bytes_accessed"; a view moves nothing and counts none)
    and the elements that the transcendental operators produce."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                counts["bytes_accessed"] += _bytes_of((args, kwargs)) \
                    + _bytes_of(out)
            name = func.overloadpacket.__name__.rstrip("_")
            if name in TRANSCENDENTAL_OPS:
                counts["transcendentals"] += _numel_of(out)
            return out

    return Counting()


def cost_analysis(fn: Callable, *example_args) -> Dict:
    """{"flops", "bytes_accessed", "transcendentals", "flops_by_op"} of one
    eager call ``fn(*example_args)`` (the call runs):

    - flops: ``FlopCounterMode``'s count, two per multiply-add, over the
      operators that have a formula (GEMMs, convolutions, attention, the
      MSDA operator by its registered formula); element-wise work counts
      none, as in XLA's count of a dot or a convolution;
    - bytes_accessed: each ATen operator's inputs and outputs, counted once
      per operator. This is the traffic of the unfused program, every
      intermediate written and read back; XLA's count is of the program
      after fusion, so an element-wise chain that XLA fuses counts more
      here. A lone GEMM or convolution counts the same in both;
    - transcendentals: the elements that exp, log, tanh, sigmoid, erf, sin,
      cos and rsqrt produce;
    - flops_by_op: {operator: flops}.

    ``FlopCounterMode`` tracks modules by hooks on the gradient of each
    module input that needs one (a parameter passed on too), which needs
    grad mode: for a forward alone under ``torch.no_grad()``, set the
    parameters to need no gradient first."""
    from torch.utils.flop_counter import FlopCounterMode
    counts = {"bytes_accessed": 0.0, "transcendentals": 0.0}
    flops = FlopCounterMode(display=False)
    # the byte count innermost: it sees each operator before the FLOP
    # counter decomposes one it has no formula for
    with flops, _counting_mode(counts):
        fn(*example_args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counts["bytes_accessed"]),
            "transcendentals": float(counts["transcendentals"]),
            "flops_by_op": {str(op): float(n) for op, n in
                            flops.get_flop_counts().get("Global",
                                                        {}).items()}}


def arithmetic_intensity(fn: Callable, *example_args) -> float:
    """Operations per byte (``cost_analysis``): the function's position on
    the roofline, unfused."""
    ca = cost_analysis(fn, *example_args)
    return ca["flops"] / max(ca["bytes_accessed"], 1.0)
