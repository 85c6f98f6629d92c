"""The PyTorch port's training commands end to end on the CPU with tiny
models (the ``test_cli.py`` cases of the JAX package): ``train_on_coco
--model panoptic|panoptic_deformable --fast_dev_run`` (the PQ table printed,
the frozen detector unchanged), ``train_on_chairs --max_steps 2`` then
``eval_on_sintel --ckpt_dir`` from its checkpoint, the flags that are not
ported, and the card rule: without ``--cpu`` both commands train on the
CUDA card, and raise without one."""

import math

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
                                   ["--log", "tensorboard"], []])
def test_train_on_chairs_refuses_what_is_not_ported(flags, tmp_path):
    """Flags of later ROADMAP items, and FlyingChairs2 on disk (no
    --sample), raise."""
    sample = [] if not flags else ["--sample"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_on_chairs.main(["--cpu", "--tiny", *sample, *flags,
                              "--log_dir", str(tmp_path)])


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
