"""bfloat16 training under tensor parallelism and FSDP on spawned gloo
ranks (``parallel.dryrun.spawn``), against the JAX package's jitted
bfloat16 step and the port's one-process bfloat16 step.

Tiny DETR and Deformable-DETR (box refinement), with feed-forward 1024 so
that both placements shard something (``torch_ranks.PLACED_TINY``), one
``Trainer.fit`` step of a global batch of 2 at 64 x 96 from JAX's
perturbed init (converted by ``utils/weights.py``), clipping off, on two
ranks: dp1 x tp2 (the feed-forward Linears column-parallel) and FSDP on
dp2 (each rank one row). The masters are taken from the placed float32
parameters before the cast: a tp parameter computes in bfloat16 over a
float32 master of its shard, FSDP's shards stay float32 (their own
masters) and are gathered in bfloat16.

Tolerances:
- against JAX's bfloat16 step (``jax.value_and_grad`` of the criterion on
  the float32 parameters of a ``dtype=bfloat16`` model, jitted, HIGHEST),
  ``chip_smoke.py``'s ``BF16_GATE_TOL``: the losses 0.1 relative, every
  gradient together 0.25 of its L2 norm;
- against one process's bfloat16 step on the global batch (one thread, as
  the ranks): ``ONE_PROCESS_TOL``, measured before it was set (see there).
  The float32 masters after the step are held by their update from the
  start: ``masters_apart`` (an element apart from one process's moved by
  at most lr in each), the share of such elements, and the L2 of the
  masters' gap over the L2 of one process's update. Masters that the step left where they were fail both
  (``test_bf16_masters_gate_catches_unmoved_masters``).
The rank-0 checkpoint holds whole float32 masters under the model's key
names: restored into one process, float32 or bfloat16, it gives the ranks'
masters exactly."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu_torch.parallel import dryrun
from aloception_tpu_torch.train import CheckpointManager, TrainOptimizer
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax)

import torch_ranks
from test_torch_bf16_detr import jax_step
from test_torch_parallel import detr_batch
from torch_parity import init_like, perturb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import BF16_GATE_TOL  # noqa: E402

# the ranks against one process's bfloat16 step on the global batch:
# metrics relative, every gradient together by L2; the float32 masters
# after the step by the share of elements that ``masters_apart`` finds
# apart (moved the other way), and by ||masters - one process's|| / ||one
# process's - start||. Measured over batch seeds 0-2 before they were set:
# metrics and gradients, tp up to 9.3e-4 and 7.5e-3 (the ranks sum the
# column-parallel Linears' input gradients over tp in bfloat16), FSDP up to
# 2.1e-2 and 9.6e-2 (each rank steps one row: batch-1 bfloat16 convolutions
# and GEMMs round apart from batch 2's, and the matcher meets near ties);
# the masters, tp up to 1.6e-3 of the elements apart and a gap of 8.3e-2,
# FSDP up to 2.4e-2 and 0.44 (DETR at seed 2, whose gradients part by
# 9.6e-2). AdamW's first step moves an element by about lr whatever the
# size of its gradient: where bfloat16 rounds a gradient to the other sign
# the element moves the other way. Masters never updated read a share of
# 0.22 (the backbone's lr 1e-5 is within the 1e-5 tolerance) and a gap of
# exactly 1.
ONE_PROCESS_TOL = {"tp": dict(metrics=5e-3, grad_l2=3e-2, share=5e-3,
                              change_l2=0.2),
                   "fsdp": dict(metrics=5e-2, grad_l2=0.2, share=5e-2,
                                change_l2=0.7)}
# TrainOptimizer's largest learning rate (the backbone's is 1e-5)
LR = 1e-4

JAX_MODELS = {
    "detr": (lambda dt: jdetr.Detr(space_to_depth=False, dtype=dt,
                                   **torch_ranks.PLACED_TINY),
             jdetr.detr_criterion, detr_state_dict_from_jax),
    "deformable": (lambda dt: jdd.DeformableDETR(
        with_box_refine=True, space_to_depth=False, dtype=dt,
        **torch_ranks.PLACED_TINY), jdd.deformable_criterion,
        lambda p: deformable_state_dict_from_jax(p, True)),
}
PLACEMENTS = {"tp": dict(tp=2), "fsdp": dict(fsdp=True)}
CASES = [f"{name}_{place}" for name in JAX_MODELS for place in PLACEMENTS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' steps (started first: they run while JAX compiles),
    JAX's bfloat16 steps and one process's bfloat16 steps."""
    root = tmp_path_factory.mktemp("bf16_ranks")
    rng = np.random.RandomState(0)
    cases, inputs = {}, {}
    for name, (make, _, convert) in JAX_MODELS.items():
        batch = detr_batch(rng)
        images, mask = batch["inputs"]
        params = perturb(init_like(make(jnp.float32), rng, images[:1],
                                   mask[:1]), rng)["params"]
        state = {k: v.numpy() for k, v in convert({"params": params}).items()}
        inputs[name] = (params, state, batch)
        for place, kw in PLACEMENTS.items():
            cases[f"{name}_{place}"] = (name, state, batch, dict(
                kw, dtype=torch.bfloat16, grad_clip=1e9))
    cfg = {"root": str(root), "config_path": str(root / "config.json"),
           "cases": cases}
    box = {}

    def run():
        try:
            box["ranks"] = dryrun.spawn(2, torch_ranks.placed_steps, cfg,
                                        timeout=400)
        except BaseException as e:     # raised below, in the fixture
            box["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    want = {}
    for name, (params, state, batch) in inputs.items():
        make, crit, convert = JAX_MODELS[name]
        images, mask = batch["inputs"]
        tg = batch["targets"]
        targets = {"boxes": jnp.asarray(tg["boxes"]),
                   "labels": jnp.asarray(tg["labels"], jnp.int32),
                   "valid": jnp.asarray(tg["valid"])}
        metrics, grads, _ = jax_step(make, crit, params, images, mask,
                                     targets, jnp.bfloat16)
        want[name] = ({k: float(v) for k, v in metrics.items()},
                      {k: v.numpy() for k, v in
                       convert({"params": grads}).items()})
    thread.join()
    if "error" in box:
        raise box["error"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: torch_ranks.one_process_step(
            name, state, batch, torch.bfloat16, torch_ranks.PLACED_TINY,
            grad_clip=1e9) for name, (_, state, batch) in inputs.items()}
    finally:
        torch.set_num_threads(threads)
    return {"ranks": box["ranks"], "want": want, "one": one,
            "start": {name: state for name, (_, state, _) in inputs.items()}}


def l2_apart(got, want, names):
    g, w = (np.concatenate([np.asarray(d[n], np.float64).ravel()
                            for n in names]) for d in (got, want))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("case", CASES)
def test_bf16_ranks_match_the_jax_step(runs, case):
    name = case.rsplit("_", 1)[0]
    want, jgrads = runs["want"][name]
    for rank in runs["ranks"]:
        got = rank[case]
        for k, w in want.items():
            assert abs(got["metrics"][k] - w) <= BF16_GATE_TOL["loss"] * \
                max(1.0, abs(w)), (case, k, got["metrics"][k], w)
        names = sorted(got["grads"])
        apart = l2_apart(got["grads"], jgrads, names)
        print(f"{case}: gradients {apart:.3e} of JAX's L2")
        assert apart <= BF16_GATE_TOL["grad_l2"], (case, apart)


def masters_apart(got, want, start, tag):
    """The float32 masters ``got`` after the step against ``want``, both
    from ``start``, as ``test_torch_parallel.updates_within`` holds them:
    an element beyond 1e-5 * max(1, max|p|) of ``want`` moved by at most lr
    in each (and that tolerance, which float32's rounding of p + update
    takes). AdamW's first step moves an element by lr * g / (|g| + 1e-8):
    such elements moved the other way (a gradient that bfloat16 rounds to
    the other sign) or by part of lr (a gradient within 1e-7 of 0).
    Returns (the share of such elements, ||got - want|| / ||want -
    start||)."""
    flips = total = 0
    gap = moved = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g, s = np.asarray(got[k], np.float64), np.asarray(start[k],
                                                          np.float64)
        tol = 1e-5 * max(1.0, float(np.abs(w).max(initial=0.0)))
        bad = np.abs(g - w) > tol
        dg, dw = (g - s)[bad], (w - s)[bad]
        assert np.abs(dg).max(initial=0.0) <= LR + tol, (tag, k)
        assert np.abs(dw).max(initial=0.0) <= LR + tol, (tag, k)
        flips += int(bad.sum())
        total += w.size
        gap += float(np.square(g - w).sum())
        moved += float(np.square(w - s).sum())
    return flips / total, (gap / moved) ** 0.5


@pytest.mark.parametrize("case", CASES)
def test_bf16_ranks_match_one_process(runs, case):
    """Metrics, gradients and the float32 masters after the step against
    one process's bfloat16 step; both ranks hold the same masters."""
    name, place = case.rsplit("_", 1)
    one = runs["one"][name]
    r0, r1 = (rank[case] for rank in runs["ranks"])
    for k in r0["masters"]:
        np.testing.assert_array_equal(r0["masters"][k], r1["masters"][k])
    got = r0
    assert set(got["metrics"]) == set(one["metrics"])
    m_err = max(abs(got["metrics"][k] - w) / max(1.0, abs(w))
                for k, w in one["metrics"].items())
    assert set(got["grads"]) == set(one["grads"])
    g_err = l2_apart(got["grads"], one["grads"], sorted(one["grads"]))
    assert set(got["masters"]) == set(one["masters"])
    share, gap = masters_apart(got["masters"], one["masters"],
                               runs["start"][name], case)
    print(f"{case}: against one process, metrics {m_err:.3e}, gradients "
          f"{g_err:.3e} of L2, masters moved the other way {share:.3e}, "
          f"their gap {gap:.3e} of the update's L2")
    tol = ONE_PROCESS_TOL[place]
    assert m_err <= tol["metrics"], m_err
    assert g_err <= tol["grad_l2"], g_err
    assert share <= tol["share"], share
    assert gap <= tol["change_l2"], gap


@pytest.mark.parametrize("case", CASES)
def test_bf16_masters_gate_catches_unmoved_masters(runs, case):
    """The masters' check of ``test_bf16_ranks_match_one_process`` fails
    on masters that the step never updated (the ranks' start state)."""
    name, place = case.rsplit("_", 1)
    start = runs["start"][name]
    one = runs["one"][name]["masters"]
    share, gap = masters_apart({k: np.asarray(v, np.float32)
                                for k, v in start.items()}, one, start, case)
    tol = ONE_PROCESS_TOL[place]
    print(f"{case}: masters left at the start, {share:.3e} of the elements "
          f"apart, their gap {gap:.3e} of the update's L2")
    assert share > tol["share"] and gap > tol["change_l2"], (share, gap)


@pytest.mark.parametrize("place", sorted(PLACEMENTS))
def test_bf16_masters_are_placed_as_their_parameters(runs, place):
    """tp: bfloat16 DTensors over float32 DTensor masters of their shards;
    FSDP: float32 shards (their own masters) beside whole bfloat16
    parameters over whole float32 masters."""
    for name in JAX_MODELS:
        got = runs["ranks"][0][f"{name}_{place}"]
        kinds = set(got["params"].values())
        assert ("torch.bfloat16", False) in kinds
        if place == "tp":
            assert ("torch.bfloat16", True) in kinds
            assert ("torch.float32", True) not in kinds
        else:
            assert ("torch.float32", True) in kinds
            assert ("torch.bfloat16", True) not in kinds
        assert ("torch.float32", True) in got["master_kinds"]
        assert all(dt == "torch.float32" for dt, _ in got["master_kinds"])


@pytest.mark.parametrize("case", CASES)
def test_bf16_checkpoint_restores_in_one_process(runs, case):
    """The rank-0 checkpoint (whole float32 masters under the model's key
    names) restored into one process: a float32 model holds the ranks'
    masters, and so do the masters of a bfloat16 one."""
    name = case.rsplit("_", 1)[0]
    got = runs["ranks"][0][case]
    for dtype in (torch.float32, torch.bfloat16):
        model = torch_ranks.build(name, torch_ranks.PLACED_TINY)
        opt = TrainOptimizer(model, dtype=dtype)
        assert CheckpointManager(got["ckpt_dir"]).restore(model, opt) == 1
        state = opt.model_state_dict(model)
        assert set(state) == set(got["masters"])
        for k, v in state.items():
            np.testing.assert_array_equal(v.float().numpy(),
                                          got["masters"][k], err_msg=k)
        assert opt.updates == 1
