"""The port's GPipe pipeline (``aloception_tpu_torch/parallel/pipeline.py``)
against the sequential stack and against the JAX package's ``gpipe``, case
for case as ``tests/test_pipeline.py``: a stack of 4 DETR encoder layers
(d_model 32, 4 heads, feed-forward 64) on 8 rows of 12 tokens, as a pp 2
pipeline of 2 microbatches over dp 4 and as a pp 4 pipeline of 4
microbatches (dp 2 here: the port's mesh has no tp for it), on 8 gloo
ranks; JAX runs on the 8 virtual devices of ``conftest.py`` (dp 4 x pp 2,
and pp 4 x tp 2). The weights are the JAX layers' (``perturb`` of its
init), converted by ``utils/weights.py``.

Each rank's output rows and this stage's layer gradients of the loss
sum(out ** 2) match the sequential stack's on the same rows, and JAX's
(its forward at both pipelines, its gradients at pp 2, as its own tests
take them; the gradients summed over dp, as JAX's loss sums over the
global batch): 1e-5 * max(1, max|ref|)."""

import threading

import numpy as np
import pytest
import torch

import jax

from aloception_tpu.models.detr.transformer import EncoderLayer
from aloception_tpu.parallel import (gpipe, make_mesh, shard_layer_stack,
                                     stack_layer_params)
from aloception_tpu_torch import parallel
from aloception_tpu_torch.models.detr.transformer import Transformer
from aloception_tpu_torch.parallel import dryrun
from aloception_tpu_torch.utils.weights import detr_layer_state_dict_from_jax

import torch_ranks
from torch_parity import perturb

D, HEADS, FFN, NLAYERS = 32, 4, 64, 4
B, L = 8, 12
JAX_MESH = {(2, 2): dict(pp=2), (4, 4): dict(pp=4, tp=2)}
JAX_GRADS = (2, 2)


def close(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, (tag, err, tol)


def port_stack(layers):
    """{port name: (N, ...)} of the JAX layers' parameters."""
    sds = [detr_layer_state_dict_from_jax(p) for p in layers]
    return {k: np.stack([sd[k].numpy() for sd in sds]) for k in sds[0]}


@pytest.fixture(scope="module")
def pipelines():
    layer = EncoderLayer(d_model=D, nheads=HEADS, dim_feedforward=FFN,
                         dropout=0.0)
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, D).astype(np.float32)
    pos = rng.randn(B, L, D).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    init = jax.jit(layer.init)
    params = [perturb(init(jax.random.PRNGKey(i), x, pos, mask)["params"],
                      rng) for i in range(NLAYERS)]
    stack = port_stack(params)
    inputs = {"x": x, "pos": pos, "mask": mask.astype(bool)}
    box = {}

    def run():            # the ranks run while JAX compiles
        try:
            box["ranks"] = dryrun.spawn(8, torch_ranks.pipelines, stack,
                                        inputs, (D, HEADS, FFN), timeout=300)
        except BaseException as e:      # raised below, in the fixture
            box["error"] = e
    thread = threading.Thread(target=run)
    thread.start()

    def apply_one(p, a, ex):
        return layer.apply({"params": p}, a, ex["pos"], ex["mask"])

    want = {}
    for cfg, mesh_kw in JAX_MESH.items():
        mesh = make_mesh(n_devices=8, **mesh_kw)

        def loss(stacked):
            out = gpipe(apply_one, stacked, x, {"pos": pos, "mask": mask},
                        mesh, n_micro=cfg[1])
            return (out ** 2).sum(), out

        stacked = shard_layer_stack(stack_layer_params(params), mesh)
        with jax.default_matmul_precision("highest"):
            if cfg != JAX_GRADS:
                want[cfg] = (np.asarray(jax.jit(loss)(stacked)[1]), None)
                continue
            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(stacked)
        grads = jax.device_get(grads)
        want[cfg] = (np.asarray(out), port_stack(
            [jax.tree.map(lambda g: g[i], grads) for i in range(NLAYERS)]))
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], want


@pytest.mark.parametrize("cfg", torch_ranks.PIPELINES)
def test_gpipe_forward_matches_sequential(pipelines, cfg):
    ranks, _ = pipelines
    for r in ranks:
        res = r[cfg]
        close(res["out"], res["seq"], (cfg, "out"))
        assert abs(res["loss"] - res["seq_loss"]) <= 1e-5 * max(
            1.0, abs(res["seq_loss"]))


@pytest.mark.parametrize("cfg", torch_ranks.PIPELINES)
def test_gpipe_forward_matches_jax(pipelines, cfg):
    """Each rank's rows (its dp slice of the 8) equal JAX's, on every
    stage (the last stage's output broadcast over pp)."""
    ranks, want = pipelines
    out, _ = want[cfg]
    for r in ranks:
        res = r[cfg]
        n = res["rows"]
        close(res["out"], out[res["dp_rank"] * n:(res["dp_rank"] + 1) * n],
              (cfg, "jax out"))


@pytest.mark.parametrize("cfg", torch_ranks.PIPELINES)
def test_gpipe_grads_match_sequential(pipelines, cfg):
    """Backprop through the pipeline: this stage's layers' gradients equal
    the sequential stack's on the rank's rows."""
    ranks, _ = pipelines
    for r in ranks:
        res = r[cfg]
        assert set(res["grads"]) == set(res["seq_grads"])
        for k, g in res["grads"].items():
            close(g, res["seq_grads"][k], (cfg, k))


def test_gpipe_grads_match_jax(pipelines):
    """This stage's layers' gradients, summed over dp, equal JAX's
    gradients of the global loss for those layers (pp 2)."""
    ranks, want = pipelines
    cfg = JAX_GRADS
    _, grads = want[cfg]
    for r in ranks:
        res = r[cfg]
        lo, hi = res["layers"]
        for k, g in res["dp_grads"].items():
            close(g, grads[k][lo:hi], (cfg, k))


def test_extract_layer_stack_from_model_params():
    """extract_layer_stack pulls the Transformer's ``encoder.layers.{i}``
    parameters, stacked on a leading layer axis."""
    tr = Transformer(d_model=D, nheads=HEADS, num_encoder_layers=2,
                     num_decoder_layers=2, dim_feedforward=FFN)
    stacked = parallel.extract_layer_stack(tr, "encoder.layers.", 2)
    assert stacked["linear1.weight"].shape == (2, FFN, D)
    torch.testing.assert_close(stacked["linear1.weight"][1],
                               tr.encoder.layers[1].linear1.weight,
                               rtol=0, atol=0)
    from_sd = parallel.extract_layer_stack(tr.state_dict(),
                                           "encoder.layers.", 2)
    assert set(from_sd) == set(stacked)
    assert all(t.requires_grad for t in stacked.values())
