"""Train RAFT on FlyingChairs2 (counterpart of
``aloception_tpu/commands/train_on_chairs.py``).

Examples
--------
python -m aloception_tpu_torch.commands.train_on_chairs --cpu --sample --tiny --max_steps 2
python -m aloception_tpu_torch.commands.train_on_chairs --batch_size 10 --max_steps 100

Reads FlyingChairs2 from the directory that the dataset config
(``~/.aloception_tpu/alodataset_config.json``, key "FlyingChairs2") names,
its ``train/`` pairs for training and ``val/`` for validation, decoded by
``--num_workers`` threads; ``--sample`` reads the offline synthetic sample
instead. Runs on the CUDA card, or on the CPU with ``--cpu``; without a card
and without ``--cpu`` it raises. With ``--max_steps`` the learning rate
follows the OneCycle schedule over max_steps + 100 updates, as the
reference. A checkpoint it writes restores in ``eval_on_sintel
--ckpt_dir``. ``--multihost`` starts the process group before the mesh is
built (``parallel.init_multihost``; NCCL on the cards, gloo with
``--cpu``): each process steps its rows of every batch (DDP), and the
context encoder's BatchNorm takes the global batch's statistics.
"""

from __future__ import annotations

import argparse

# flags of the JAX command that the port does not take, with their ROADMAP
# item
NOT_PORTED = {"steps_per_dispatch": "A12: the TPU's scan-blocked dispatch"}


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--sample", action="store_true",
                   help="read the offline synthetic sample, not the "
                        "FlyingChairs2 directory")
    p.add_argument("--small", action="store_true", help="RAFT-small")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=2,
                   help="threads that decode the pairs")
    p.add_argument("--max_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--fast_dev_run", action="store_true",
                   help="2 train batches + 1 val batch")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--run_id", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_dir", default=None,
                   help="experiment root (default ~/.aloception_tpu/"
                        "experiments via the alonet config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    p.add_argument("--log", default=None, choices=[None, "tensorboard", "tb"],
                   help="write a TensorBoard event file into the run's "
                        "checkpoint directory")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group before building the mesh "
                        "(ALO_COORDINATOR_ADDRESS / ALO_NUM_PROCESSES / "
                        "ALO_PROCESS_ID, or torchrun's variables)")
    p.add_argument("--steps_per_dispatch", type=int, default=None)
    args = p.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported (ROADMAP {item})")
    if args.multihost:
        from aloception_tpu_torch.parallel import init_multihost
        init_multihost(device="cpu" if args.cpu else None)

    import torch
    from aloception_tpu_torch.models.raft import RAFTBase, built
    from aloception_tpu_torch.models.transformers import entry_device
    from aloception_tpu_torch.train import (Data2RAFT, EPECallback,
                                            MetricsCallback, make_raft_trainer)

    device = entry_device("cpu" if args.cpu else None)
    dm = Data2RAFT(batch_size=args.batch_size, num_workers=args.num_workers,
                   sample=args.sample, seed=args.seed)
    kwargs = dict(data_module=dm, small=args.small, iters=args.iters,
                  run_id=args.run_id, num_steps=args.max_steps, device=device,
                  seed=args.seed, log=args.log,
                  callbacks=[MetricsCallback(), EPECallback()])
    if args.log_dir:
        kwargs["log_dir"] = args.log_dir
    if args.tiny:
        kwargs["model"] = built(RAFTBase(hidden_dim=32, context_dim=32,
                                         corr_levels=2, corr_radius=2,
                                         device=device), torch.float32)
    if args.fast_dev_run:
        kwargs["limit_train_batches"] = 2
        kwargs["limit_val_batches"] = 1
        args.max_epochs = 1
    trainer = make_raft_trainer(**kwargs)
    trainer.fit(dm.train_dataloader(), dm.val_dataloader(),
                max_epochs=args.max_epochs, max_steps=args.max_steps,
                resume=args.resume)
    print(f"[train_on_chairs] done: step={trainer.global_step} "
          f"val={trainer.last_val_metrics} ckpt={trainer.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
