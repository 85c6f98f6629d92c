"""``utils/profiling.py`` and ``train.params_update`` of the port against
the JAX package's on the CPU.

``cost_analysis`` is held against JAX's (XLA's cost model of the compiled
program) on functions where fusion changes nothing: one matmul (FLOPs
2MNK and bytes equal), one unpadded convolution (FLOPs equal; XLA leaves
out the multiplies on padding, so a padded one counts fewer there), and
``exp`` of a matrix (transcendentals and bytes equal). The MSDA operator
counts its registered formula; ``trace`` writes a trace file;
``params_update`` sets what JAX's sets."""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.train import experiment as jexp
from aloception_tpu.utils import profiling as jprof
from aloception_tpu_torch.utils import profiling as tprof


def test_matmul_cost_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(64, 96).astype(np.float32)
    b = rng.randn(96, 48).astype(np.float32)
    want = jprof.cost_analysis(lambda x, y: x @ y, a, b)
    got = tprof.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a),
                              torch.from_numpy(b))
    assert {k: got[k] for k in want} == want
    assert got["flops_by_op"] == {"aten.mm": got["flops"]}
    assert got["flops"] == 2 * 64 * 96 * 48
    assert got["bytes_accessed"] == 4 * (64 * 96 + 96 * 48 + 64 * 48)
    assert tprof.arithmetic_intensity(
        lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b)) == \
        pytest.approx(jprof.arithmetic_intensity(lambda x, y: x @ y, a, b))


@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_convolution_flops_match_jax(stride):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 20, 24, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)
    want = jprof.cost_analysis(
        lambda x, w: jax.lax.conv_general_dilated(
            x, w, stride, "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")), x, w)
    got = tprof.cost_analysis(
        lambda x, w: torch.nn.functional.conv2d(x, w, stride=stride),
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(w).permute(3, 2, 0, 1).contiguous())
    assert got["flops"] == want["flops"] > 0


def test_exp_transcendentals_match_jax():
    m = np.random.RandomState(2).randn(50, 70).astype(np.float32)
    want = jprof.cost_analysis(jnp.exp, m)
    got = tprof.cost_analysis(torch.exp, torch.from_numpy(m))
    assert got["transcendentals"] == want["transcendentals"] == 50 * 70
    assert got["bytes_accessed"] == want["bytes_accessed"]


def test_msda_counts_its_formula():
    """The MSDA operator reaches the FLOP counter whole: two operations per
    multiply-add of its registered formula, on this data."""
    from aloception_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                         msda_fmas)
    rng = np.random.RandomState(3)
    shapes = [(8, 12), (4, 6)]
    value = torch.from_numpy(rng.randn(1, 96 + 24, 2, 8).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (1, 10, 2, 2, 3, 2))
                           .astype(np.float32))
    w = torch.from_numpy(rng.rand(1, 10, 2, 2, 3).astype(np.float32))
    got = tprof.cost_analysis(ms_deform_attn, value, shapes, loc, w)
    want = 2 * msda_fmas(value.shape, [s for hw in shapes for s in hw],
                         loc, w)
    assert got["flops"] == want > 0
    assert list(got["flops_by_op"]) == [
        "aloception_tpu_torch.ms_deform_attn"]


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as d:
        torch.exp(torch.ones(64, 64)).sum()
    assert d == log_dir
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::exp" for e in events)


@pytest.mark.parametrize("args", [None, {"lr": 1e-3, "depth": 2},
                                  argparse.Namespace(lr=1e-3, depth=2)])
def test_params_update_matches_jax(args):
    from aloception_tpu_torch.train import params_update

    class Obj:
        pass

    kwargs = {"depth": 6, "name": "x"}
    got = params_update(Obj(), args, kwargs)
    want = jexp.params_update(Obj(), args, kwargs)
    assert vars(got) == vars(want)
    assert got._init_kwargs_config == want._init_kwargs_config
    assert got.depth == 6


def test_train_exports_what_jax_exports():
    import aloception_tpu.train as jtrain
    import aloception_tpu_torch.train as ttrain
    for name in ("params_update", "TensorBoardLogger"):
        assert hasattr(jtrain, name) and hasattr(ttrain, name), name
