"""RAFT training of the PyTorch port on the CPU: the EPE falls on a
repeated batch through ``make_raft_trainer``'s train step. Split from
``tests/test_torch_raft_train.py`` (a file of its own, so that the suite's
workers, which take whole files, share the load)."""

import torch

from test_torch_raft_train import tiny_raft


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
