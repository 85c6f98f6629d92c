"""The PyTorch port's training commands end to end on the CPU with tiny
models (the ``test_cli.py`` cases of the JAX package): ``train_on_coco
--model panoptic|panoptic_deformable --fast_dev_run`` (the PQ table printed,
the frozen detector unchanged), ``train_on_chairs --max_steps 2`` then
``eval_on_sintel --ckpt_dir`` from its checkpoint, the flags that are not
ported, and the card rule: without ``--cpu`` both commands train on the
CUDA card, and raise without one."""

import glob
import math
import os

import numpy as np

import pytest
import torch

from aloception_tpu_torch.commands import (eval_on_sintel, train_on_chairs,
                                           train_on_coco)
from aloception_tpu_torch.train import experiment


@pytest.fixture(autouse=True)
def private_config(tmp_path, monkeypatch):
    """The experiment config is written under the test's own directory."""
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))


@pytest.mark.parametrize("model", ["panoptic", "panoptic_deformable"])
def test_train_on_coco_panoptic_fast_dev_run(model, tmp_path, capsys,
                                             monkeypatch):
    from aloception_tpu_torch.models import panoptic
    built = []
    init = panoptic.DetrPanoptic.__init__

    def recording(self, *a, **k):
        init(self, *a, **k)
        built.append({n: v.clone() for n, v in self.detr.state_dict().items()})
    monkeypatch.setattr(panoptic.DetrPanoptic, "__init__", recording)
    trainer = train_on_coco.main(
        ["--cpu", "--sample", "--tiny", "--fast_dev_run", "--model", model,
         "--size", "64", "96", "--batch_size", "2",
         "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train_on_coco] done: step=2" in out and "PQ[all]" in out
    assert trainer.ckpt.last_step() == 2
    assert math.isfinite(trainer.last_val_metrics["val_loss_DICE"])
    assert trainer.optimizer.updates == 2
    det = trainer.model.detr.state_dict()
    assert all(torch.equal(det[n], v) for n, v in built[0].items())
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


def test_raft_train_then_eval_from_checkpoint(tmp_path, capsys):
    trainer = train_on_chairs.main(
        ["--cpu", "--sample", "--tiny", "--max_steps", "2",
         "--batch_size", "2", "--iters", "2", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train_on_chairs] done: step=2" in out and "[EPE]" in out
    epe = eval_on_sintel.main(
        ["--cpu", "--sample", "--tiny", "--iters", "2",
         "--ckpt_dir", trainer.ckpt_dir, "--limit_samples", "2"])
    out = capsys.readouterr().out
    assert "[eval] restored step 2" in out
    assert "[eval_on_sintel] EPE=" in out and math.isfinite(epe)


@pytest.mark.parametrize("flags", [["--multihost"],
                                   ["--steps_per_dispatch", "4"],
                                   ["--log", "tensorboard", "--multihost"],
                                   []])
def test_train_on_chairs_refuses_what_is_not_ported(flags, tmp_path,
                                                    monkeypatch):
    """Flags of later ROADMAP items, beside ported ones too (``--log``),
    raise. With no flag the command reads FlyingChairs2 from disk: it
    refuses only a dataset directory that the config does not name
    (FileNotFoundError), and trains on the one it names."""
    if flags:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_on_chairs.main(["--cpu", "--tiny", "--sample", *flags,
                                  "--log_dir", str(tmp_path)])
        return
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.utils.flow_fixture import build_chairs2_dir
    config = tmp_path / "alodataset_config.json"
    monkeypatch.setattr(base_dataset, "CONFIG_PATH", str(config))
    argv = ["--cpu", "--tiny", "--max_steps", "1", "--iters", "1",
            "--log_dir", str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="FlyingChairs2"):
        train_on_chairs.main(argv)
    build_chairs2_dir(str(tmp_path / "chairs"), seed=0, n_train=2, n_val=2,
                      hw=(16, 24))
    config.write_text('{"FlyingChairs2": "%s"}' % (tmp_path / "chairs"))
    trainer = train_on_chairs.main(argv)
    assert trainer.global_step == 1
    assert trainer.data_module.train_dataset.dir_path == str(
        tmp_path / "chairs" / "train")


def event_scalars(ckpt_dir):
    """{tag: [steps]} of the scalars in the run's one event file, read by
    TensorBoard's loader (which checks each record's CRCs)."""
    from tensorboard.backend.event_processing.event_file_loader import (
        LegacyEventFileLoader)
    (path,) = glob.glob(os.path.join(ckpt_dir, "*tfevents*"))
    tags = {}
    for event in LegacyEventFileLoader(path).Load():
        for value in event.summary.value:
            assert value.WhichOneof("value") == "simple_value"
            assert math.isfinite(value.simple_value)
            tags.setdefault(value.tag, []).append(event.step)
    return tags


@pytest.mark.parametrize("model", ["detr", "deformable",
                                   "panoptic_deformable"])
def test_train_on_coco_bf16_with_tensorboard(model, tmp_path):
    """``--bf16 --log tensorboard``: the model computes in bfloat16 (its
    norms in float32) over float32 masters, the checkpoint holds float32
    weights, and the run's directory an event file of the validation
    metrics (the train ones are logged every 10 steps, as the JAX
    package's ``MetricsCallback`` does)."""
    trainer = train_on_coco.main(
        ["--cpu", "--sample", "--tiny", "--fast_dev_run", "--bf16", "--log",
         "tensorboard", "--model", model, "--size", "64", "96",
         "--batch_size", "2", "--log_dir", str(tmp_path)])
    assert trainer.global_step == 2
    dtypes = {n: p.dtype for n, p in trainer.model.named_parameters()}
    assert torch.bfloat16 in dtypes.values()
    assert all(d == torch.float32 for n, d in dtypes.items() if "norm" in n)
    assert trainer.optimizer.low
    saved = trainer.ckpt.restore_tree()["model"]
    assert all(saved[n].dtype == torch.float32 for n in dtypes)
    assert math.isfinite(trainer.last_val_metrics["val_loss_total"])
    tags = event_scalars(trainer.ckpt_dir)
    assert tags["val/loss_total"] == [2]
    assert not any(tag.startswith("train/") for tag in tags)


def test_train_on_chairs_with_tensorboard(tmp_path):
    trainer = train_on_chairs.main(
        ["--cpu", "--sample", "--tiny", "--max_steps", "2", "--batch_size",
         "2", "--iters", "2", "--log", "tensorboard", "--log_dir",
         str(tmp_path)])
    tags = event_scalars(trainer.ckpt_dir)
    assert tags["val/EPE"] == [2] and "val/1px" in tags


@pytest.mark.parametrize("command,argv", [
    (train_on_chairs, ["--sample", "--tiny", "--max_steps", "1",
                       "--iters", "2"]),
    (train_on_coco, ["--sample", "--tiny", "--fast_dev_run", "--model",
                     "panoptic", "--size", "64", "96"])],
    ids=["train_on_chairs", "train_on_coco"])
def test_training_runs_on_the_card_or_raises(command, argv, tmp_path):
    argv = argv + ["--log_dir", str(tmp_path)]
    if torch.cuda.is_available():
        trainer = command.main(argv)
        assert {p.device.type for p in trainer.model.parameters()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            command.main(argv)


# ----------------------------------------------------------------------
# COCO on disk and the multi-scale recipe
# ----------------------------------------------------------------------
@pytest.fixture
def coco_on_disk(tmp_path, monkeypatch):
    """A COCO-format directory of the image fixtures, named as "coco" in a
    private dataset config of both packages."""
    from pathlib import Path
    import aloception_tpu.alodataset.base_dataset as jbase
    import aloception_tpu_torch.alodataset.base_dataset as tbase
    from aloception_tpu_torch.utils.coco_fixture import build_coco_dir
    fixtures = Path(__file__).resolve().parent / "fixtures" / "torch_coco"
    jpegs = sorted(str(p) for p in fixtures.glob("*.jpg")
                   if p.name != "corrupt.jpg")
    root = build_coco_dir(str(tmp_path / "coco"), jpegs, seed=4, n_train=4,
                          n_val=2, objects=(1, 12))
    cfg = str(tmp_path / "alodataset_config.json")
    monkeypatch.setattr(jbase, "CONFIG_PATH", cfg)
    monkeypatch.setattr(tbase, "CONFIG_PATH", cfg)
    tbase.save_dataset_config({"coco": root})
    return root


def test_train_and_eval_multiscale_on_disk(coco_on_disk, tmp_path, capsys,
                                           monkeypatch):
    """train_on_coco --multiscale (Deformable-DETR, tiny) for 2 steps on
    the directory, then eval_on_coco --multiscale on its val split. The
    scales and buckets are cut (shorter side 128-160) to keep the CPU's
    convolutions short; the real ones are held without a model below."""
    import functools
    from aloception_tpu_torch.commands import eval_on_coco
    from aloception_tpu_torch.train import data_modules
    monkeypatch.setattr(data_modules, "REFERENCE_SCALES", [128, 160])
    monkeypatch.setattr(data_modules, "pick_bucket", functools.partial(
        data_modules.pick_bucket, buckets=((128, 192), (192, 256))))
    trainer = train_on_coco.main(
        ["--cpu", "--tiny", "--multiscale", "--model", "deformable",
         "--fast_dev_run", "--batch_size", "2", "--num_workers", "2",
         "--log_dir", str(tmp_path)])
    assert trainer.global_step == 2
    assert math.isfinite(trainer.last_val_metrics["val_loss_total"])
    maps = eval_on_coco.main(["--cpu", "--tiny", "--multiscale", "--model",
                              "deformable", "--limit_batches", "1"])
    out = capsys.readouterr().out
    assert "[eval_on_coco] AP=" in out and 0.0 <= maps["all"]["all"] <= 100


def test_coco_on_disk_without_a_directory_raises(tmp_path, monkeypatch):
    import os
    import aloception_tpu_torch.alodataset.base_dataset as tbase
    monkeypatch.setattr(tbase, "CONFIG_PATH", str(tmp_path / "none.json"))
    monkeypatch.setattr(os, "isatty", lambda fd: False)
    with pytest.raises(FileNotFoundError, match="coco"):
        train_on_coco.main(["--cpu", "--tiny", "--log_dir", str(tmp_path)])


def test_multiscale_prepare_batch_matches_jax(coco_on_disk):
    """The multi-scale validation batches (shorter side 800, longer at most
    1333): the same buckets, padding masks and targets as the JAX data
    module's, images within 1e-4 (the bilinear resize's last bits)."""
    from aloception_tpu.train import CocoDetection2Detr as JaxDM
    from aloception_tpu_torch.train import CocoDetection2Detr
    tdm = CocoDetection2Detr(size=None, batch_size=2, num_workers=0)
    jdm = JaxDM(size=None, batch_size=2, num_workers=0)
    for tb, jb in zip(tdm.val_dataloader(), jdm.val_dataloader()):
        got = tdm.prepare_batch(tb, training=False)
        want = jdm.prepare_batch(jb, training=False)
        gi, gm = got["inputs"]
        wi, wm = want["inputs"]
        assert gi.shape == wi.shape
        np.testing.assert_array_equal(gm.numpy(), wm)
        np.testing.assert_allclose(gi.numpy(), wi, atol=1e-4, rtol=0)
        for k, v in want["targets"].items():
            np.testing.assert_allclose(got["targets"][k].numpy(),
                                       np.asarray(v), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(800, 1066), (1066, 800), (800, 1199),
                                (480, 640), (1333, 750), (900, 1400)])
def test_pick_bucket_matches_jax(hw):
    from aloception_tpu.train.data_modules import pick_bucket as jax_pick
    from aloception_tpu_torch.train.data_modules import pick_bucket
    assert pick_bucket(*hw) == jax_pick(*hw)


def test_multiscale_train_frames_fit_their_buckets(coco_on_disk):
    """The train transform's frames (flip, multi-scale resize or
    resize-crop-resize): shorter side at most 800, longer at most 1333, and
    every batch padded to the bucket that holds its frames (a 64-multiple
    square where a landscape and a portrait frame share a batch)."""
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train.data_modules import (MULTISCALE_BUCKETS,
                                                         pick_bucket)
    dm = CocoDetection2Detr(size=None, batch_size=2, num_workers=2, seed=3)
    shapes = {tuple(sorted(b)) for b in MULTISCALE_BUCKETS}
    for _ in range(2):
        for frames in dm.train_dataloader():
            batch = dm.prepare_batch(frames)
            hw = tuple(batch["inputs"][0].shape[1:3])
            want = pick_bucket(max(f.H for f in frames),
                               max(f.W for f in frames))
            assert hw == want
            assert tuple(sorted(hw)) in shapes or hw[0] % 64 == hw[1] % 64 == 0
            for f in frames:
                assert max(f.HW) <= 1333 and min(f.HW) <= 800
                assert f.normalization == "resnet"


def test_multiscale_batches_do_not_depend_on_the_workers(coco_on_disk):
    """Each sample draws from a generator of (seed, epoch, index) with a
    copy of the transforms of its own: two loaders of 2 worker threads and
    one of none give equal batches over two epochs, and an index draws anew
    in the next epoch."""
    from aloception_tpu_torch.train import CocoDetection2Detr

    def run(workers):
        dm = CocoDetection2Detr(size=None, batch_size=2, num_workers=workers,
                                seed=3)
        loader = dm.train_dataloader()
        return dm, [[dm.prepare_batch(frames)["inputs"][0]
                     for frames in loader] for _ in range(2)]

    dm, want = run(2)
    for _, got in (run(2), run(0)):
        for g_epoch, w_epoch in zip(got, want):
            assert len(g_epoch) == len(w_epoch) == 2
            for g, w in zip(g_epoch, w_epoch):
                assert torch.equal(g, w)
    ds = dm.train_dataset
    assert any(ds.get(i, 0).HW != ds.get(i, 1).HW
               or not torch.equal(ds.get(i, 0).array, ds.get(i, 1).array)
               for i in range(len(ds)))
