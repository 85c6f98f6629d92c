"""RAFT training of the PyTorch port against the JAX package on the CPU:
``raft_sequence_loss`` with ``valid`` and ``max_flow``; the context
encoder's BatchNorm in train mode (batch statistics, the running ones moved
by flax's rule); one train step of a tiny RAFT (3 iterations, the
all-iterations path): loss, metrics, every gradient and the running
statistics after it, against ``jax.value_and_grad`` with
``mutable=["batch_stats"]``; the FlyingChairs2 sample and the sign of its
flow (read with ``ops.warp``); ``Data2RAFT`` batches; the OneCycle learning
rates of ``make_raft_trainer`` against the JAX schedule; and the EPE falling
on a repeated batch through the trainer's step.

The port is NCHW, the JAX package NHWC. Variables are drawn as flax's init
draws them (``init_like``), moved by noise (``perturb``) and loaded through
``utils/weights.py``; the JAX side runs at HIGHEST matmul precision.
Tolerances: the loss and metrics 1e-5 relative (one pass over the flows);
BatchNorm outputs 1e-5 and running statistics 1e-6; the train step's loss
and metrics 1e-4 relative, running statistics 1e-5, each gradient 5e-3 of
its tensor's largest magnitude or 1e-6 of the model's largest where a
tensor's gradients are near 0 (the biases of convolutions that a norm
follows): through 3 recurrent steps the float32 gradients of either package
stand up to 1.9e-3 of a tensor's largest from the port's float64 ones;
samples and batches equal; learning rates 1e-7 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models.raft import criterion as jcrit
from aloception_tpu.models.raft import extractor as jext
from aloception_tpu.models.raft import raft as jraft
from aloception_tpu_torch.models import raft as traft
from aloception_tpu_torch.models.raft import extractor as text
from aloception_tpu_torch.utils.weights import raft_state_dict_from_jax

from test_torch_aloscene import same
from test_torch_raft import TINY, nchw, nhwc
from torch_parity import init_like, perturb, t


def rel(got, want, tol, tag=""):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (tag, got, want)


@pytest.mark.parametrize("with_valid", [True, False])
def test_sequence_loss_matches_jax(with_valid):
    """Weights gamma^(n-i-1); the L1 a mean over every element with invalid
    pixels zeroed; pixels at or above max_flow invalid; EPE and 1/3/5 px over
    the valid pixels."""
    rng = np.random.RandomState(int(with_valid))
    B, H, W, n = 2, 12, 20, 4
    gt = (4 * rng.randn(B, H, W, 2)).astype(np.float32)
    gt[0, :3] = 30.0                                    # |gt| >= max_flow
    preds = [(gt + (n - i) * rng.randn(B, H, W, 2)).astype(np.float32)
             for i in range(n)]
    valid = (rng.rand(B, H, W) > 0.3).astype(np.float32) if with_valid \
        else None
    want_loss, want = jcrit.raft_sequence_loss(preds, gt, valid,
                                               max_flow=40.0)
    got_loss, got = traft.raft_sequence_loss(
        [nchw(p) for p in preds], nchw(gt),
        None if valid is None else t(valid), max_flow=40.0)
    rel(got_loss, want_loss, 1e-5, "loss")
    assert set(got) == set(want)
    for k in want:
        rel(got[k], want[k], 1e-5, k)


def test_batchnorm_train_mode_follows_flax():
    """Normalised by the batch's biased statistics; the running variance
    moved toward the biased batch variance (nn.BatchNorm2d would move it
    toward the unbiased one: 0.8 % apart at 2 x 8 x 8 values a channel)."""
    rng = np.random.RandomState(4)
    x = (2 + 3 * rng.randn(2, 8, 8, 6)).astype(np.float32)
    bn = jext.make_norm("batch", train=True)("bn", 6)
    v = bn.init(jax.random.PRNGKey(0), x)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.randn(6).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    want, mut = bn.apply(v, x, mutable=["batch_stats"])

    port = text.make_norm("batch", 6, 8).train()
    with torch.no_grad():
        port.weight.copy_(t(v["params"]["scale"]))
        port.bias.copy_(t(v["params"]["bias"]))
        port.running_mean.copy_(t(v["batch_stats"]["mean"]))
        port.running_var.copy_(t(v["batch_stats"]["var"]))
        got = port(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               mut["batch_stats"]["var"], atol=1e-6)
    unbiased = 0.9 * v["batch_stats"]["var"] + 0.1 * x.var((0, 1, 2), ddof=1)
    assert np.abs(port.running_var.numpy() - unbiased).max() > 1e-4


def test_train_step_matches_flax():
    """The tiny RAFT (hidden 32, context 32, 2 levels, radius 2) in train
    mode at 64x96, 3 iterations: the sequence loss and its metrics, the
    gradient of every parameter, and the cnet's running statistics after
    the step, against flax with ``deterministic=False`` and
    ``mutable=["batch_stats"]``."""
    rng = np.random.RandomState(20)
    jm = jraft.RAFTBase(**TINY)
    f0 = np.zeros((1, 64, 64, 3), np.float32)
    v = perturb(init_like(jm, rng, f0, f0, iters=1), rng)
    f1, f2 = (rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
              for _ in range(2))
    gt = (3 * rng.randn(2, 64, 96, 2)).astype(np.float32)
    valid = (rng.rand(2, 64, 96) > 0.2).astype(np.float32)

    def loss_fn(params):
        flows, mut = jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, f1, f2,
                              iters=3, deterministic=False,
                              mutable=["batch_stats"])
        loss, metrics = jcrit.raft_sequence_loss(flows, gt, valid)
        return loss, (metrics, mut["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (want, stats)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
    want_grads = raft_state_dict_from_jax(
        {"params": jax.device_get(jgrads), "batch_stats": v["batch_stats"]})
    want_stats = raft_state_dict_from_jax(
        {"params": v["params"], "batch_stats": jax.device_get(stats)})

    port = traft.built(traft.RAFTBase(**TINY), torch.float32)
    port.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    port.train()
    flows = port(nchw(f1), nchw(f2), iters=3)
    loss, got = traft.raft_sequence_loss(flows, nchw(gt), t(valid))
    loss.backward()

    assert len(flows) == 3 and set(got) == set(want)
    for k in want:
        rel(got[k], want[k], 1e-4, k)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    top = max(float(want_grads[n].abs().max()) for n in grads)
    for n, g in grads.items():
        ref = want_grads[n].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= max(5e-3 * np.abs(ref).max(), 1e-6 * top), (n, err)
    buffers = dict(port.named_buffers())
    moved = [n for n in buffers if n.startswith("cnet.")
             and n.endswith(("running_mean", "running_var"))]
    assert moved
    for n in moved:
        np.testing.assert_allclose(buffers[n].numpy(),
                                   want_stats[n].numpy(), atol=1e-5,
                                   err_msg=n)
        assert not torch.equal(buffers[n],
                               raft_state_dict_from_jax(v)[n]), n


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("idx", [0, 3, 7])
def test_chairs_sample_matches_jax(idx):
    from aloception_tpu.alodataset import FlyingChairs2Dataset as JChairs
    from aloception_tpu_torch.alodataset import FlyingChairs2Dataset
    tds = FlyingChairs2Dataset(sample=True)
    got, want = tds[idx], JChairs(sample=True).getitem(idx)
    assert len(tds) == 8
    same(got, want)
    assert got.names == ("T", "C", "H", "W") and got.shape == (2, 3, 96, 128)
    flow = got[0].get_child("flow")["flow_forward"]
    assert flow.shape == (2, 96, 128)
    assert float(flow.get_child("occlusion").array.abs().max()) == 0.0
    assert got[1].get_child("flow") is None


def test_sample_flow_sign_is_inverted():
    """The samples label the flow with the opposite sign to the image
    shift: backward-warping the second frame by the negated label gives
    the first (interior, integer shift), by the label it does not."""
    from aloception_tpu_torch.alodataset import (FlyingChairs2Dataset,
                                                 SintelFlowDataset)
    from aloception_tpu_torch.ops.warp import warp
    for ds, idx in ((FlyingChairs2Dataset(sample=True), 1),
                    (SintelFlowDataset(sample=True), 0)):
        pair = ds[idx]
        i0, i1 = pair.array[0], pair.array[1]
        flow = pair[0].get_child("flow")["flow_forward"].array
        assert float(flow.abs().max()) > 0
        inner = (slice(None), slice(8, -8), slice(8, -8))
        assert torch.allclose(warp(i1, -flow)[inner], i0[inner], atol=1e-3)
        assert not torch.allclose(warp(i1, flow)[inner], i0[inner],
                                  atol=1.0)


@pytest.mark.parametrize("dataset", ["chairs", "sintel"])
def test_data2raft_batch_matches_jax(dataset):
    """``prepare_batch`` of the same pairs: the JAX NHWC batch transposed
    to NCHW; ``valid`` = 1 - occlusion."""
    from aloception_tpu.train import Data2RAFT as JaxDM
    from aloception_tpu_torch.train import Data2RAFT
    jdm, tdm = JaxDM(sample=True, dataset=dataset), \
        Data2RAFT(sample=True, dataset=dataset)
    jb = jdm.prepare_batch([jdm.train_dataset.getitem(i) for i in (1, 2)])
    tb = tdm.prepare_batch([tdm.train_dataset[i] for i in (1, 2)])
    for g, w in zip(tb["inputs"], jb["inputs"]):
        assert g.shape == (2, 3, 96, 128)
        np.testing.assert_array_equal(nhwc(g), w)
    np.testing.assert_array_equal(nhwc(tb["targets"]["flow"]),
                                  jb["targets"]["flow"])
    np.testing.assert_array_equal(tb["targets"]["valid"].numpy(),
                                  jb["targets"]["valid"])


def test_data2raft_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Every flow dataset is ported, as samples and on disk: the things and
    sdhom samples give the JAX package's batches; without ``sample`` the
    directory comes from the dataset config, and what is refused is a
    dataset without one (FileNotFoundError, in both packages); with one,
    the pairs read from disk give the JAX package's batches."""
    import aloception_tpu.alodataset.base_dataset as jbase
    import aloception_tpu_torch.alodataset.base_dataset as tbase
    from aloception_tpu.train import Data2RAFT as JaxDM
    from aloception_tpu_torch.train import Data2RAFT
    from aloception_tpu_torch.utils.flow_fixture import build_chairs2_dir
    config = str(tmp_path / "alodataset_config.json")
    monkeypatch.setattr(jbase, "CONFIG_PATH", config)
    monkeypatch.setattr(tbase, "CONFIG_PATH", config)
    cases = [dict(sample=True, dataset=d) for d in ("things", "sdhom")]
    for dm in (JaxDM, Data2RAFT):
        with pytest.raises(FileNotFoundError, match="FlyingChairs2"):
            dm(sample=False)
    build_chairs2_dir(str(tmp_path / "chairs"), seed=1, hw=(16, 24))
    with open(config, "w") as f:
        f.write('{"FlyingChairs2": "%s"}' % (tmp_path / "chairs"))
    cases.append(dict(sample=False, dataset="chairs"))
    for kw in cases:
        jdm, tdm = JaxDM(**kw), Data2RAFT(**kw)
        jb = jdm.prepare_batch([jdm.train_dataset.getitem(i) for i in (0, 1)])
        tb = tdm.prepare_batch([tdm.train_dataset[i] for i in (0, 1)])
        for g, w in zip(tb["inputs"], jb["inputs"]):
            np.testing.assert_array_equal(nhwc(g), w)
        np.testing.assert_array_equal(nhwc(tb["targets"]["flow"]),
                                      jb["targets"]["flow"])
        np.testing.assert_array_equal(tb["targets"]["valid"].numpy(),
                                      jb["targets"]["valid"])


def tiny_raft(seed=0):
    return traft.built(traft.RAFTBase(
        **TINY, device="cpu", generator=torch.Generator().manual_seed(seed)),
        torch.float32)


def test_onecycle_learning_rates_match_jax(tmp_path, monkeypatch):
    """With num_steps, the learning rate of each update is the JAX
    package's OneCycle schedule over num_steps + 100 at that update."""
    from aloception_tpu.train.state import onecycle_schedule as jsched
    from aloception_tpu_torch.train import experiment, make_raft_trainer
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))
    trainer = make_raft_trainer(model=tiny_raft(), num_steps=20,
                                log_dir=str(tmp_path))
    opt = trainer.optimizer
    assert opt.grad_clip == 1.0 and opt.lr == opt.lr_backbone == 4e-4
    assert all(g["weight_decay"] == 1e-4 for g in opt.adamw.param_groups)
    schedule = jsched(4e-4, 120)
    for k in range(12):
        for p in opt.params:
            p.grad = torch.zeros_like(p)
        opt.step()
        rel(opt.adamw.param_groups[0]["lr"], schedule(k), 1e-7, str(k))


def test_epe_falls_on_a_repeated_batch(tmp_path, monkeypatch):
    """Eight steps of ``make_raft_trainer``'s train step (AdamW lr 4e-4,
    clip 1.0, 3 iterations) on one chairs batch: the EPE falls and the
    cnet's running statistics move."""
    from aloception_tpu_torch.train import (Data2RAFT, experiment,
                                            make_raft_trainer)
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))
    dm = Data2RAFT(sample=True, batch_size=2)
    model = tiny_raft(1)
    trainer = make_raft_trainer(model=model, data_module=dm, iters=3,
                                log_dir=str(tmp_path))
    batch = dm.prepare_batch([dm.train_dataset[i] for i in (0, 5)])
    before = model.cnet.norm1.running_var.clone()
    epes = []
    for _ in range(8):
        keys, packed = trainer.train_step(batch["inputs"], batch["targets"])
        epes.append(dict(zip(keys, packed.tolist()))["epe"])
    assert epes[-1] < epes[0], epes
    assert not torch.equal(model.cnet.norm1.running_var, before)
