"""The PyTorch port's Trainer on the CPU, replaying the semantics of
``tests/test_trainer.py`` on a tiny DETR: fit with checkpointing and
validation, resume continuing, best/last pruning, frozen BatchNorm never
updating, ``pick_bucket`` (the loss falling on a repeated batch:
``test_torch_trainer_overfit.py``); the
``train_on_coco`` command for both detectors; and the synthetic COCO sample,
frame for frame against the JAX package's. The JAX package's scan-blocked
dispatch (``steps_per_dispatch``) is not ported."""

import numpy as np
import pytest
import torch

from aloception_tpu_torch.alodataset import CocoBaseDataset
from aloception_tpu_torch.models.detr import Detr
from aloception_tpu_torch.train import (CheckpointManager, CocoDetection2Detr,
                                        MetricsCallback, make_detr_trainer,
                                        pick_bucket)
from aloception_tpu_torch.train import experiment


@pytest.fixture(autouse=True)
def private_config(tmp_path, monkeypatch):
    """The experiment config is written under the test's own directory."""
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))


def tiny_detr(n_classes, seed=0, **kw):
    return Detr(num_classes=n_classes, hidden_dim=32, num_queries=8, nheads=4,
                num_encoder_layers=1, num_decoder_layers=1,
                dim_feedforward=32, stage_sizes=(1, 1, 1, 1), device="cpu",
                generator=torch.Generator().manual_seed(seed), **kw)


def make_trainer(log_dir, **kw):
    dm = CocoDetection2Detr(sample=True, size=(64, 96), batch_size=4)
    kw = {"accumulate_grad_batches": 1, "limit_train_batches": 1,
          "limit_val_batches": 1, **kw}
    return make_detr_trainer(model=tiny_detr(len(dm.label_names)),
                             data_module=dm, log_dir=str(log_dir),
                             callbacks=[MetricsCallback()], **kw)


def test_fit_and_checkpoint(tmp_path):
    trainer = make_trainer(tmp_path)
    dm = trainer.data_module
    trainer.fit(dm.train_dataloader(), dm.val_dataloader(), max_epochs=1)
    assert trainer.global_step == 1
    assert "val_loss_total" in trainer.last_val_metrics
    assert trainer.ckpt.last_step() == 1
    assert trainer.ckpt._registry["1"]["val_loss_total"] == pytest.approx(
        trainer.last_val_metrics["val_loss_total"], rel=1e-5)
    tree = trainer.ckpt.restore_tree()
    assert tree["step"] == 1 and set(tree) >= {"model", "optimizer", "rng"}
    assert set(tree["model"]) == set(trainer.model.state_dict())


def test_resume_continues(tmp_path):
    t1 = make_trainer(tmp_path, expe_name="resume", run_id="fixed")
    dm = t1.data_module
    t1.fit(dm.train_dataloader(), dm.val_dataloader(), max_epochs=1)
    t2 = make_trainer(tmp_path, expe_name="resume", run_id="fixed")
    t2.fit(dm.train_dataloader(), dm.val_dataloader(), max_epochs=1,
           resume=True)
    assert t2.ckpt.last_step() == 2          # continued past step 1
    assert t2.optimizer.updates == 2
    # step 1's checkpoint holds the first run's weights
    for (n, a), b in zip(t1.model.state_dict().items(),
                         t2.ckpt.restore_tree(step=1)["model"].values()):
        assert torch.equal(a, b), n


def test_checkpoint_best_pruning(tmp_path):
    cm = CheckpointManager(str(tmp_path), monitor="val_loss", mode="min",
                           save_top_k=1, save_last=True)
    model = torch.nn.Linear(4, 1)
    for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0)):   # best 2, last 3
        with torch.no_grad():
            model.weight.fill_(float(step))
        cm.save(step, {"model": model.state_dict(), "step": step},
                {"val_loss": loss})
    assert cm.best_step() == 2
    assert cm.last_step() == 3
    assert {int(s) for s in cm._registry} == {2, 3}   # step 1 pruned
    assert not (tmp_path / "1").exists()
    assert cm.restore(model, best=True) == 2
    assert torch.equal(model.weight, torch.full((1, 4), 2.0))
    assert cm.restore_tree()["step"] == 3


def test_frozen_bn_never_updates(tmp_path):
    """Frozen BatchNorm statistics are buffers: out of the optimizer, out
    of the gradient norm, unchanged by training; the backbone's parameters
    train at the backbone's rate."""
    trainer = make_trainer(tmp_path)
    model, opt = trainer.model, trainer.optimizer
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    assert any("backbone" in n for n in buffers)
    in_opt = {id(p) for g in opt.adamw.param_groups for p in g["params"]}
    assert not any(id(b) in in_opt for b in model.buffers())
    backbone = [p for n, p in model.named_parameters() if "backbone" in n]
    assert backbone and opt.adamw.param_groups[1]["params"] == backbone
    assert opt.adamw.param_groups[1]["lr"] == 1e-5
    before = [p.clone() for p in backbone]
    dm = trainer.data_module
    trainer.fit(dm.train_dataloader(), None, max_epochs=2)
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert any(not torch.equal(a, p) for a, p in zip(before, backbone))


def test_pick_bucket_covers_every_shape():
    from aloception_tpu_torch.train.data_modules import MULTISCALE_BUCKETS
    rng = np.random.RandomState(0)
    shapes = set()
    for _ in range(200):
        short = rng.randint(480, 801)
        long = rng.randint(short, 1334)
        h, w = (short, long) if rng.rand() < 0.5 else (long, short)
        bh, bw = pick_bucket(h, w)
        assert bh >= h and bw >= w
        assert (min(bh, bw), max(bh, bw)) in MULTISCALE_BUCKETS
        shapes.add((bh, bw))
    assert len(shapes) <= 2 * len(MULTISCALE_BUCKETS)
    assert pick_bucket(1400, 100) == (1408, 128)    # none fits: 64-rounded


@pytest.mark.parametrize("model", ["detr", "deformable"])
def test_train_on_coco_command(model, tmp_path):
    from aloception_tpu_torch.commands.train_on_coco import main
    trainer = main(["--cpu", "--sample", "--tiny", "--fast_dev_run",
                    "--model", model, "--size", "64", "96",
                    "--log_dir", str(tmp_path)])
    assert trainer.global_step == 2
    assert trainer.ckpt.last_step() == 2
    assert np.isfinite(trainer.last_val_metrics["val_loss_total"])
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


@pytest.mark.parametrize("flags", [
    ["--log", "tensorboard", "--steps_per_dispatch", "4"],
    ["--bf16", "--multihost", "--steps_per_dispatch", "2"],
    ["--tp", "2", "--steps_per_dispatch", "4"], ["--steps_per_dispatch", "4"]])
def test_train_on_coco_refuses_what_is_not_ported(flags, tmp_path):
    """The flag the port does not take (the TPU's scan-blocked dispatch,
    ROADMAP A12) raises, beside ported ones too (``--multiscale``, COCO on
    disk, ``--bf16`` and ``--log``: ``tests/test_torch_train_cli.py``;
    ``--tp`` and ``--multihost``: ``tests/test_torch_parallel.py``)."""
    from aloception_tpu_torch.commands.train_on_coco import main
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--cpu", "--tiny", "--sample", *flags,
              "--log_dir", str(tmp_path)])


@pytest.fixture(scope="module")
def jax_sample():
    from aloception_tpu.alodataset import CocoBaseDataset as JaxCoco
    return JaxCoco(sample=True)


@pytest.mark.parametrize("idx", range(12))
def test_sample_frames_match_jax(idx, jax_sample):
    """The same image, boxes and labels from the same index."""
    want = jax_sample[idx]
    got = CocoBaseDataset(sample=True)[idx]
    np.testing.assert_array_equal(got.as_numpy(), np.asarray(want.as_numpy()))
    assert got.normalization == want.normalization == "255"
    gb, wb = got.boxes2d, want.boxes2d
    assert (gb.boxes_format, gb.absolute) == (wb.boxes_format, wb.absolute)
    np.testing.assert_array_equal(gb.as_numpy(), np.asarray(wb.as_numpy()))
    gl, wl = gb.get_child("labels"), wb.get_child("labels")
    np.testing.assert_array_equal(gl.as_numpy(), np.asarray(wl.as_numpy()))
    assert list(gl.labels_names) == list(wl.labels_names)


def test_finetune_params_grafts_all_but_the_class_head():
    """Every pretrained tensor of the same name and shape is grafted; the
    class head (a ``reinit_keys`` component, and of another class count)
    keeps its fresh values."""
    from aloception_tpu_torch.models.detr import finetune_params
    pretrained = tiny_detr(10, seed=1).state_dict()
    fresh = tiny_detr(3, seed=2).state_dict()
    out = finetune_params(fresh, pretrained)
    assert out.keys() == fresh.keys()
    for name, value in out.items():
        if name.startswith("class_embed."):
            assert value is fresh[name]
        else:
            assert value is pretrained[name], name
    kept = finetune_params(fresh, pretrained, reinit_keys=("bbox_embed",))
    assert all(kept[n] is fresh[n] for n in fresh if "bbox_embed" in n)
