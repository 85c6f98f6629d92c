"""The port's parallel package (``aloception_tpu_torch/parallel``) against
the JAX package's on the CPU, case for case as ``tests/test_parallel.py``,
and its multi-rank paths on spawned gloo ranks.

- ``default_mesh_shape`` / ``make_mesh``, ``param_partition_spec`` on the
  JAX test's cases, and the set of tp- and FSDP-sharded parameters of the
  tiny DETR against the JAX rule's set, mapped through ``utils/weights.py``
  (each JAX leaf filled with its own id and converted; the JAX rule also
  shards the frozen BatchNorm's biases, which are buffers in the port and
  never placed);
- ``init_multihost``'s environment cases, with ``init_process_group``
  recorded;
- the commands' flags, and 2 processes under ``torchrun`` (one checkpoint
  directory, written by rank 0);
- 8 ranks (``parallel.dryrun``): dp4 x tp2, FSDP on it, dp2 x sp2 x tp2 for
  DETR and Deformable-DETR (refine), each loss within 1e-4 (relative) of
  the replicated step, with the shards checked;
- 2 ranks through ``Trainer.fit`` (DDP): tiny DETR and Deformable-DETR
  (refine, plain MSDA on the CPU), with unequal valid targets per rank,
  against the JAX package's jitted step on the global batch from the same
  converted weights: metrics within 1e-4 relative, the updated parameters
  within 1e-5 * max(1, max|p|) of each tensor; RAFT's BatchNorm running
  statistics within 1e-5 of flax's global-batch update; what each rank
  writes; a two-rank checkpoint restored into one process, and a run of two
  ranks resumed from one process's checkpoint, equal to one process's step.

The ranks import numpy, torch and the port only (``torch_ranks.py``). Dropout
is 0: JAX draws one mask over the global batch, the ranks their own."""

import argparse
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu.models.raft import criterion as jraft_crit
from aloception_tpu.models.raft import raft as jraft
from aloception_tpu.parallel import mesh as jmesh
from aloception_tpu.parallel import shard as jshard
from aloception_tpu.train import make_train_state
from aloception_tpu.train.step import make_detr_train_step
from aloception_tpu_torch import parallel
from aloception_tpu_torch.parallel import dryrun, shard
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax,
                                                raft_state_dict_from_jax)

import torch_ranks
from torch_parity import init_like, perturb

H, W, NT = 64, 96, 6


# ----------------------------------------------------------------------
# mesh and partition rules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,tp,sp,pp", [(8, None, None, None),
                                        (8, 2, None, None), (8, 2, 2, None),
                                        (8, None, None, 2), (8, 4, None, 2),
                                        (1, None, None, None)])
def test_default_mesh_shape_matches_jax(n, tp, sp, pp):
    assert parallel.default_mesh_shape(n, tp, sp, pp) == \
        jmesh.default_mesh_shape(n, tp, sp, pp)


@pytest.mark.parametrize("n,tp,sp,pp", [(6, 4, None, None),
                                        (8, 3, None, None)])
def test_default_mesh_shape_refuses_what_jax_refuses(n, tp, sp, pp):
    with pytest.raises(AssertionError):
        jmesh.default_mesh_shape(n, tp, sp, pp)
    with pytest.raises(AssertionError):
        parallel.default_mesh_shape(n, tp, sp, pp)


def test_make_mesh_without_a_process_group():
    """One process: no mesh (the mesh of one); tp 2 cannot divide it."""
    assert parallel.make_mesh() is None
    assert parallel.mesh.mesh_shape(None) == dict(dp=1, pp=1, sp=1, tp=1)
    with pytest.raises(AssertionError):
        parallel.make_mesh(tp=2)


class _Key:
    def __init__(self, k):
        self.key = k


class _Shape:
    def __init__(self, shape):
        self.shape, self.ndim = shape, len(shape)
        self.size = int(np.prod(shape))


# JAX's cases (tests/test_parallel.py): (flax shape, name, tp, dp, fsdp);
# the port's Linear holds the kernel transposed
SPEC_CASES = [((64, 1024), "kernel", 2, 1, False),
              ((64, 1024), "kernel", 2, 4, True),
              ((64, 1024), "kernel", 1, 4, True),
              ((64,), "bias", 2, 4, True)]


@pytest.mark.parametrize("case", SPEC_CASES)
def test_param_partition_spec_matches_jax(case):
    shape, name, tp, dp, fsdp = case
    want = jshard.param_partition_spec((_Key("layer"), _Key(name)),
                                       _Shape(shape), tp=tp, dp=dp, fsdp=fsdp)
    port_shape = shape[::-1]
    got = parallel.param_partition_spec(torch.empty(port_shape), tp, dp,
                                        fsdp, kind="linear")
    want = tuple(want) + (None,) * (len(shape) - len(tuple(want)))
    got = got + (None,) * (len(shape) - len(got))
    assert got == want[::-1]


def _jax_detr():
    return jdetr.Detr(num_classes=7, hidden_dim=64, num_queries=12, nheads=4,
                      num_encoder_layers=1, num_decoder_layers=1,
                      dim_feedforward=1024, stage_sizes=(1, 1, 1, 1),
                      dropout=0.0, space_to_depth=False)


@pytest.fixture(scope="module")
def detr_ids():
    """{port name: ids of the JAX leaves it is made of} and {JAX id: its
    path}, through the converter of every JAX leaf filled with its id."""
    shapes = jax.eval_shape(lambda: _jax_detr().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64))))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    filled = jax.tree_util.tree_unflatten(
        tree, [np.full(s.shape, i + 1, np.float32)
               for i, (_, s) in enumerate(leaves)])
    sd = detr_state_dict_from_jax(filled)
    ids = {k: set(np.unique(v.numpy()).astype(int)) - {0}
           for k, v in sd.items()}
    return ids, {i + 1: (p, s) for i, (p, s) in enumerate(leaves)}


@pytest.mark.parametrize("tp,dp,fsdp", [(2, 1, False), (1, 4, True),
                                        (2, 4, True)])
def test_sharded_parameters_match_the_jax_rule(detr_ids, tp, dp, fsdp):
    """The tiny DETR's parameters that the port's rule places (tp, dp or
    both) are those made of the leaves the JAX rule shards."""
    ids, leaves = detr_ids
    jax_sharded = {i for i, (p, s) in leaves.items()
                   if len(jshard.param_partition_spec(p, s, tp, dp, fsdp))}
    from aloception_tpu_torch.models.detr import Detr
    port = Detr(num_classes=7, hidden_dim=64, num_queries=12, nheads=4,
                num_encoder_layers=1, num_decoder_layers=1,
                dim_feedforward=1024, stage_sizes=(1, 1, 1, 1), device="cpu")
    specs = shard.partition_specs(port, tp, dp, fsdp)
    got = {n for n, s in specs.items() if s}
    want = {n for n in specs if ids[n] & jax_sharded}
    assert got and got == want
    for axis in ("tp", "dp"):
        got_axis = {n for n, s in specs.items() if axis in s}
        want_axis = {n for n in specs if any(
            axis in tuple(jshard.param_partition_spec(
                *leaves[i], tp, dp, fsdp)) for i in ids[n])}
        assert got_axis == want_axis, axis


# ----------------------------------------------------------------------
# init_multihost
# ----------------------------------------------------------------------
@pytest.fixture
def recorded_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for var in ("ALO_COORDINATOR_ADDRESS", "ALO_NUM_PROCESSES",
                "ALO_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_init_multihost_env_driven(recorded_init, monkeypatch):
    """The ALO_* variables start the group (gloo where the caller asked for
    the CPU); explicit arguments win; a coordinator without the rank
    variables raises and starts nothing."""
    monkeypatch.setenv("ALO_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("ALO_NUM_PROCESSES", "4")
    monkeypatch.setenv("ALO_PROCESS_ID", "2")
    assert parallel.init_multihost(device="cpu") is True
    (args, kw), = recorded_init
    assert args == ("gloo",)
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == \
        ("tcp://10.0.0.1:8476", 4, 2)
    recorded_init.clear()
    assert parallel.init_multihost("file:///tmp/x", 2, 1,
                                   device="cpu") is True
    assert recorded_init[0][1]["init_method"] == "file:///tmp/x"
    monkeypatch.delenv("ALO_NUM_PROCESSES")
    monkeypatch.delenv("ALO_PROCESS_ID")
    recorded_init.clear()
    with pytest.raises(ValueError):
        parallel.init_multihost(device="cpu")
    assert not recorded_init


def test_init_multihost_single_process_noop(recorded_init):
    """Nothing configured: no group, a single process goes on."""
    assert parallel.init_multihost(device="cpu") is False
    assert not recorded_init


def test_init_multihost_torchrun_environment(recorded_init, monkeypatch):
    """torchrun's variables (the JAX package's pod auto-detect): env://."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parallel.init_multihost(device="cpu") is True
    (args, kw), = recorded_init
    assert (args, kw["init_method"], kw["rank"], kw["world_size"]) == \
        (("gloo",), "env://", 1, 2)


# ----------------------------------------------------------------------
# the commands
# ----------------------------------------------------------------------
@pytest.mark.parametrize("command,flags", [
    ("train_on_coco", ["--tp", "2", "--multihost"]),
    ("train_on_chairs", ["--multihost"])])
def test_commands_accept_the_parallel_flags(command, flags, monkeypatch):
    """The flags of both JAX commands parse, and are no longer refused."""
    from aloception_tpu.commands import train_on_coco as jcoco
    from aloception_tpu_torch.commands import train_on_chairs, train_on_coco
    if command == "train_on_coco":
        args = train_on_coco.add_argparse_args(
            argparse.ArgumentParser()).parse_args(flags)
        want = jcoco.add_argparse_args(
            argparse.ArgumentParser()).parse_args(flags)
        assert (args.tp, args.multihost) == (want.tp, want.multihost) \
            == (2, True)
        not_ported = train_on_coco.NOT_PORTED
    else:
        seen = {}

        def stop(self, argv=None, namespace=None):
            seen["args"] = argparse.ArgumentParser.parse_known_args(
                self, argv)[0]
            raise SystemExit(0)
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(SystemExit):
            train_on_chairs.main(flags)
        assert seen["args"].multihost is True
        not_ported = train_on_chairs.NOT_PORTED
    assert set(not_ported) == {"steps_per_dispatch"}


@pytest.mark.parametrize("how", ["train_on_coco --bf16 --tp 2",
                                 "Trainer fsdp bf16"])
def test_placed_lower_precision_is_refused(how, monkeypatch, tmp_path):
    """bf16 under tp or FSDP raises, whether the factories build the
    optimizer (the command's ``--bf16``) or the caller does."""
    for var in ("ALO_COORDINATOR_ADDRESS", "ALO_NUM_PROCESSES",
                "ALO_PROCESS_ID", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(NotImplementedError, match="lower-precision"):
        if how.startswith("train_on_coco"):
            from aloception_tpu_torch.commands import train_on_coco
            train_on_coco.main(["--cpu", "--sample", "--tiny", "--bf16",
                                "--tp", "2", "--multihost", "--log_dir",
                                str(tmp_path / "expe")])
        else:
            from aloception_tpu_torch.train import Trainer
            Trainer(torch.nn.Linear(4, 4), lambda out, t: {},
                    prepare_batch=lambda raw, training=True: raw,
                    log_dir=str(tmp_path / "expe"), fsdp=True,
                    dtype=torch.bfloat16)


def test_torchrun_two_processes_write_one_checkpoint_dir(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...train_on_coco --cpu --sample
    --tiny --fast_dev_run --multihost``: both ranks step (DDP), rank 0 alone
    makes the run's directory and writes its checkpoint."""
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1")
    log_dir = tmp_path / "expe"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "aloception_tpu_torch.commands.train_on_coco", "--cpu", "--sample",
         "--tiny", "--fast_dev_run", "--multihost", "--size", "64", "96",
         "--log_dir", str(log_dir)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = [d for d, _, files in os.walk(log_dir) if "registry.json" in files]
    assert len(runs) == 1, runs
    assert os.listdir(os.path.join(runs[0], "2")) == ["checkpoint.pt"]
    assert res.stdout.count("[train_on_coco] done: step=2") == 2
    assert res.stdout.count(f"ckpt={runs[0]}") == 2


# ----------------------------------------------------------------------
# 8 ranks: the dry run's placements
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def eight_ranks():
    return dryrun.gather_references(
        dryrun.spawn(8, dryrun.placement_passes, timeout=400))


@pytest.mark.parametrize("tag", dryrun.PASSES)
def test_placement_loss_matches_replicated(eight_ranks, tag):
    model = "deformable" if tag.endswith("deformable") else "detr"
    ref = eight_ranks[0]["replicated"][model]
    for res in eight_ranks:
        got = res[tag]["metrics"]
        assert set(got) == set(ref)
        for k, w in ref.items():
            assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (tag, k)


@pytest.mark.parametrize("tag", dryrun.PASSES)
def test_placement_is_real(eight_ranks, tag):
    """B / dp rows a rank; a tp parameter holds 1 / tp of its elements, an
    FSDP one 1 / dp; all-reduces, and >= 2 collectives under tp."""
    dryrun.check([{"replicated": eight_ranks[0]["replicated"],
                   "dp_tp": r["dp_tp"], tag: r[tag]} for r in eight_ranks],
                 [])
    got = eight_ranks[0][tag]
    assert got["rows"] == 8 // got["dp"]
    fracs = sorted({s for s, _ in got["shares"].values()})
    want = {"dp_tp": [0.5], "fsdp": [0.125, 0.25, 0.5],
            "sp": [0.5], "sp_deformable": [0.5]}[tag]
    assert fracs == want, fracs


# ----------------------------------------------------------------------
# 2 ranks through Trainer.fit against the JAX package's global step
# ----------------------------------------------------------------------
def detr_batch(rng):
    """A global batch of 2; the ranks' valid target counts differ (1 and
    5), so that a per-rank denominator would show."""
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[1, :, 64:] = 1.0
    valid = np.arange(NT)[None] < np.array([[1], [5]])
    boxes = np.concatenate([rng.uniform(0.2, 0.7, (2, NT, 2)),
                            rng.uniform(0.1, 0.4, (2, NT, 2))], -1)
    return {"inputs": (images, mask),
            "targets": {"boxes": (boxes * valid[..., None]).astype(np.float32),
                        "labels": (rng.randint(0, 5, (2, NT)) * valid
                                   ).astype(np.int64),
                        "valid": valid}}


JAX_MODELS = {
    "detr": (lambda: jdetr.Detr(space_to_depth=False,
                                **torch_ranks.DETR_TINY),
             jdetr.detr_criterion, detr_state_dict_from_jax),
    "deformable": (lambda: jdd.DeformableDETR(
        with_box_refine=True, space_to_depth=False, **torch_ranks.DETR_TINY),
        jdd.deformable_criterion,
        lambda p: deformable_state_dict_from_jax(p, True)),
}


def jax_detr_step(name, params, batch):
    """The JAX package's jitted train step on the global batch: (metrics,
    the updated parameters under the port's names)."""
    make, crit, convert = JAX_MODELS[name]
    model = make()
    images, mask = batch["inputs"]
    tg = batch["targets"]
    targets = {"boxes": jnp.asarray(tg["boxes"]),
               "labels": jnp.asarray(tg["labels"], jnp.int32),
               "valid": jnp.asarray(tg["valid"])}
    state = make_train_state(model, {"params": params})
    with jax.default_matmul_precision("highest"):
        new, metrics = make_detr_train_step(model, crit, donate=False)(
            state, images, mask, targets)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in convert(
                jax.device_get(new.params)).items()})


def jax_raft_step(variables, batch):
    """Flax's train-mode RAFT on the global batch: (metrics, the running
    statistics after it under the port's names)."""
    model = jraft.RAFTBase(**torch_ranks.RAFT_TINY)
    f1, f2 = (np.moveaxis(x, 1, -1) for x in batch["inputs"])
    flow = np.moveaxis(batch["targets"]["flow"], 1, -1)
    def step(v):
        flows, mut = model.apply(v, f1, f2, iters=torch_ranks.RAFT_ITERS,
                                 deterministic=False, mutable=["batch_stats"])
        return jraft_crit.raft_sequence_loss(
            flows, flow, batch["targets"]["valid"])[1], mut

    with jax.default_matmul_precision("highest"):
        metrics, mut = jax.jit(step)(variables)
    stats = raft_state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": mut["batch_stats"]})
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in stats.items()})


def port_step(name, state, batch, root, run_id):
    """One process's Trainer step from ``state`` on the global batch (the
    checkpoint that the two ranks resume from)."""
    cap = torch_ranks.Capture()
    trainer = torch_ranks.make_trainer(name, state, batch, root, run_id, cap)
    trainer.fit([None], max_steps=1)
    return trainer, cap


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX global steps, one process's steps and the two ranks' Trainer
    runs (started first: they run while JAX compiles)."""
    root = tmp_path_factory.mktemp("two_ranks")
    from aloception_tpu_torch.train import experiment
    saved_config, experiment.CONFIG_PATH = (experiment.CONFIG_PATH,
                                            str(root / "config.json"))
    try:
        rng = np.random.RandomState(0)
        cases, jax_params = {}, {}
        for name, (make, _, convert) in JAX_MODELS.items():
            batch = detr_batch(rng)
            images, mask = batch["inputs"]
            params = perturb(init_like(make(), rng, images[:1], mask[:1]),
                             rng)["params"]
            jax_params[name] = params
            cases[name] = ({k: v.numpy() for k, v in convert(
                {"params": params}).items()}, batch)
        rv = perturb(init_like(jraft.RAFTBase(**torch_ranks.RAFT_TINY), rng,
                               np.zeros((1, 64, 64, 3), np.float32),
                               np.zeros((1, 64, 64, 3), np.float32),
                               iters=1), rng)
        raft_batch = {
            "inputs": tuple(rng.uniform(-1, 1, (2, 3, 64, 96))
                            .astype(np.float32) for _ in range(2)),
            "targets": {"flow": (3 * rng.randn(2, 2, 64, 96))
                        .astype(np.float32),
                        "valid": (rng.rand(2, 64, 96) > 0.2)
                        .astype(np.float32)}}
        cases["raft"] = ({k: v.numpy() for k, v in
                          raft_state_dict_from_jax(rv).items()}, raft_batch)
        # one process's steps on the global batch; DETR's first is the
        # checkpoint the two ranks resume (a copy: this process resumes the
        # first while they run)
        single = {name: port_step(name, *cases[name], str(root), "one")
                  for name in ("detr", "deformable", "raft")}
        single = {name: ({k: v.detach().numpy().copy() for k, v in
                          tr.model.state_dict().items()}, cap.metrics[0],
                         tr.ckpt_dir) for name, (tr, cap) in single.items()}
        for copy in ("-ranks", "-fsdp"):
            shutil.copytree(single["detr"][2], single["detr"][2] + copy)
        cfg = {"root": str(root), "config_path": str(root / "config.json"),
               "models": cases,
               "resume": ("detr", *cases["detr"], "one-ranks"),
               "resume_fsdp": ("detr", *cases["detr"], "one-fsdp")}
        box = {}

        def run():
            try:
                box["ranks"] = dryrun.spawn(2, torch_ranks.trainer_steps,
                                            cfg, timeout=400)
            except BaseException as e:     # raised below, in the test
                box["error"] = e
        thread = threading.Thread(target=run)
        thread.start()
        want = {name: jax_detr_step(name, jax_params[name], cases[name][1])
                for name in ("detr", "deformable")}
        want["raft"] = jax_raft_step(rv, raft_batch)
        # one process's second step, from the restored first
        cap = torch_ranks.Capture()
        again = torch_ranks.make_trainer("detr", *cases["detr"], str(root),
                                         "one", cap)
        again.fit([None], max_steps=2, resume=True)
        thread.join()
        if "error" in box:
            raise box["error"]
        yield {"ranks": box["ranks"], "want": want, "cases": cases,
               "single": single, "single2": (again, cap)}
    finally:
        experiment.CONFIG_PATH = saved_config


def rel(got, want, tol, tag):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (tag, got, want)


@pytest.mark.parametrize("name", ["detr", "deformable", "raft"])
def test_two_rank_metrics_match_the_global_step(two_ranks, name):
    """Against JAX's global step (its ``grad_norm`` also counts the frozen
    BatchNorm's gradients, which the port holds as buffers: compared with
    one process's step instead), and against one process's step."""
    want, _ = two_ranks["want"][name]
    _, one, _ = two_ranks["single"][name]
    for rank in two_ranks["ranks"]:
        got, = rank[name]["metrics"]
        assert set(got) == set(one) and set(want) - {"grad_norm"} <= set(got)
        for k, w in want.items():
            if k != "grad_norm":
                rel(got[k], w, 1e-4, (name, k))
        for k, w in one.items():
            rel(got[k], w, 1e-4, (name, k))


def updates_within(got, want, start, lr, tag):
    """Each tensor of ``got`` within 1e-5 * max(1, max|p|) of ``want``,
    except where the two updates from ``start`` have opposite signs. AdamW's
    first step moves a parameter by lr * g / (|g| + 1e-8): a gradient
    within float32 noise of 0 moves it by +-lr in either package. Those
    elements are bounded by lr and counted; returns their count."""
    flips = 0
    for k, w in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(w).max(initial=0.0)))
        bad = np.abs(got[k] - w) > tol
        if not bad.any():
            continue
        dg, dw = (got[k] - start[k])[bad], (w - start[k])[bad]
        assert (np.sign(dg) != np.sign(dw)).all(), (tag, k)
        assert np.abs(dg).max() <= lr and np.abs(dw).max() <= lr, (tag, k)
        flips += int(bad.sum())
    return flips


@pytest.mark.parametrize("name", ["detr", "deformable"])
def test_two_rank_updated_parameters_match_the_global_step(two_ranks, name):
    """Every parameter and buffer within 1e-5 * max(1, max|p|) of one
    process's step, and of JAX's but for the sign flips of
    ``updates_within``: at most 1 in 1,000,000 elements (none at this
    seed; 4 of DETR's 8,344,202, in the backbone's convolutions, with two
    encoder layers)."""
    _, want = two_ranks["want"][name]
    one, _, _ = two_ranks["single"][name]
    start = two_ranks["cases"][name][0]
    for rank in two_ranks["ranks"]:
        got = rank[name]["state"]
        assert set(got) == set(want) == set(one)
        assert updates_within(got, one, start, 0.0, name) == 0
        flips = updates_within(got, want, start, 1e-4 * (1 + 1e-3), name)
        assert flips <= 1e-6 * sum(v.size for v in want.values()), flips


def test_two_rank_batchnorm_statistics_match_the_global_batch(two_ranks):
    _, want = two_ranks["want"]["raft"]
    moved = [k for k in want if k.startswith("cnet.")
             and k.endswith(("running_mean", "running_var"))]
    assert moved
    start = two_ranks["cases"]["raft"][0]
    for rank in two_ranks["ranks"]:
        got = rank["raft"]["state"]
        for k in moved:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)
            assert not np.array_equal(got[k], start[k]), k


@pytest.mark.parametrize("name", ["detr", "deformable", "raft"])
def test_two_rank_placement_and_writes(two_ranks, name):
    """DDP over both ranks, one row each; rank 0 alone writes (the
    checkpoint, the registry, DETR's event file) into the one directory."""
    r0, r1 = (rank[name] for rank in two_ranks["ranks"])
    assert r0["ckpt_dir"] == r1["ckpt_dir"]
    assert r0["forward"] == r1["forward"] == "DistributedDataParallel"
    assert r0["rows"] == r1["rows"] == 1
    assert (r0["writes"], r1["writes"]) == (True, False)
    events = ["TensorBoardLogger", "NoOpLogger"] if name == "detr" \
        else ["NoOpLogger"] * 2
    assert [r0["logger"], r1["logger"]] == events
    files = [f for f in r0["files"] if not f.startswith("events.")]
    assert files == ["1/checkpoint.pt", "registry.json"]
    assert len(r0["files"]) - len(files) == (name == "detr")


def test_two_rank_checkpoint_restores_in_one_process(two_ranks):
    """The two ranks' checkpoint loads into one process's model: equal to
    what the ranks hold."""
    from aloception_tpu_torch.train import CheckpointManager, TrainOptimizer
    r0 = two_ranks["ranks"][0]["detr"]
    model = torch_ranks.build("detr")
    opt = TrainOptimizer(model)
    assert CheckpointManager(r0["ckpt_dir"]).restore(model, opt) == 1
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), r0["state"][k], err_msg=k)
    assert opt.updates == 1


@pytest.mark.parametrize("run", ["resume", "resume_fsdp"])
def test_two_ranks_resume_one_process_checkpoint(two_ranks, run):
    """Two ranks resume one process's checkpoint and take the second step,
    under DDP and under FSDP (each rank loads its shards from the whole
    tensors, and saves whole tensors): the step, the metrics and the
    parameters of one process's second step (1e-4 relative, 1e-5 *
    max(1, max|p|))."""
    again, cap = two_ranks["single2"]
    for rank in two_ranks["ranks"]:
        got = rank[run]
        if run == "resume_fsdp":
            assert "backbone.0.body.layer4.0.conv2.weight" in got["sharded"]
        assert got["step"] == again.global_step == 2
        for k, v in again.model.state_dict().items():
            w = v.numpy()
            tol = 1e-5 * max(1.0, float(np.abs(w).max(initial=0.0)))
            assert np.abs(got["state"][k] - w).max(initial=0.0) <= tol, k
        for k, w in cap.metrics[-1].items():
            rel(got["metrics"][-1][k], w, 1e-4, k)
