"""FSDP beside sequence parallelism on 4 spawned gloo ranks
(``parallel.dryrun.spawn``): dp2 x sp2, the parameters above FSDP's size
threshold sharded over dp (the JAX rule's ``P("dp")`` at any sp: the sp
ranks of one dp row hold the same shard), the encoders' tokens split over
sp, against one process stepping the global batch in float32.

Tiny DETR and Deformable-DETR (box refinement; its MSDA samples for the
rank's Lq / sp queries), ``torch_ranks.PLACED_TINY``, a global batch of 4
at 64 x 96 (a dp row of 2), one ``Trainer.fit`` step each, gradients
clipped at 0.1 as the Trainer's default. The ranks' gates: every metric
within 1e-4 (relative), each gradient tensor within 1e-3 of its max|g|;
the float32 parameters after the step within 1e-5 * max(1, max|p|) but
for AdamW's sign flips (``test_torch_parallel.updates_within``); the
rank-0 checkpoint restored into one process equal to the ranks'."""

import numpy as np
import pytest
import torch

from aloception_tpu_torch.parallel import dryrun
from aloception_tpu_torch.train import CheckpointManager, TrainOptimizer

import torch_ranks
from test_torch_parallel import updates_within

NAMES = ("detr", "deformable")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp_sp")
    batch = dryrun.detr_batch(4, seed=3, hw=(64, 96), n_targets=6)
    batch["targets"]["labels"].remainder_(torch_ranks.PLACED_TINY[
        "num_classes"])
    batch = {"inputs": tuple(x.numpy() for x in batch["inputs"]),
             "targets": {k: v.numpy() for k, v in batch["targets"].items()}}
    cases, states = {}, {}
    for i, name in enumerate(NAMES):
        torch.manual_seed(i)
        states[name] = torch_ranks.numpy_state(
            torch_ranks.build(name, torch_ranks.PLACED_TINY))
        cases[name] = (name, states[name], batch, dict(fsdp=True, sp=2))
    cfg = {"root": str(root), "config_path": str(root / "config.json"),
           "cases": cases}
    ranks = dryrun.spawn(4, torch_ranks.placed_steps, cfg, timeout=400)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the ranks' count: CPU sums round by it
    try:
        one = {name: torch_ranks.one_process_step(
            name, states[name], batch, tiny=torch_ranks.PLACED_TINY)
            for name in NAMES}
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "one": one, "start": states}


@pytest.mark.parametrize("name", NAMES)
def test_fsdp_sp_metrics_and_gradients_match_one_process(runs, name):
    one = runs["one"][name]
    for rank in runs["ranks"]:
        got = rank[name]
        assert set(got["metrics"]) == set(one["metrics"])
        for k, w in one["metrics"].items():
            assert abs(got["metrics"][k] - w) <= 1e-4 * max(1.0, abs(w)), \
                (name, k, got["metrics"][k], w)
        assert set(got["grads"]) == set(one["grads"])
        for k, w in one["grads"].items():
            err = np.abs(got["grads"][k] - w).max(initial=0.0)
            assert err <= 1e-3 * max(np.abs(w).max(initial=0.0), 1e-30), \
                (name, k, err)


@pytest.mark.parametrize("name", NAMES)
def test_fsdp_sp_parameters_match_one_process(runs, name):
    """The float32 parameters after the step, on every rank: one model."""
    one, start = runs["one"][name], runs["start"][name]
    r0 = runs["ranks"][0][name]["masters"]
    for rank in runs["ranks"][1:]:
        for k, v in rank[name]["masters"].items():
            np.testing.assert_array_equal(v, r0[k], err_msg=k)
    flips = updates_within(r0, one["masters"], start, 1e-4 * (1 + 1e-3),
                           name)
    assert flips <= 1e-6 * sum(v.size for v in r0.values()), flips


@pytest.mark.parametrize("name", NAMES)
def test_fsdp_sp_placement(runs, name):
    """FSDP's shards on every rank: the sp ranks of a dp row hold the same
    shards, the rest whole."""
    for rank in runs["ranks"]:
        kinds = set(rank[name]["params"].values())
        assert kinds == {("torch.float32", True), ("torch.float32", False)}
    sharded = [k for k, (_, placed) in
               runs["ranks"][0][name]["params"].items() if placed]
    assert "transformer.encoder.layers.0.linear1.weight" in sharded


def test_fsdp_sp_checkpoint_restores_in_one_process(runs):
    for name in NAMES:
        got = runs["ranks"][0][name]
        model = torch_ranks.build(name, torch_ranks.PLACED_TINY)
        opt = TrainOptimizer(model)
        assert CheckpointManager(got["ckpt_dir"]).restore(model, opt) == 1
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), got["masters"][k],
                                          err_msg=k)
