"""Train DETR, Deformable-DETR or the panoptic head on COCO (counterpart of
``aloception_tpu/commands/train_on_coco.py``).

Examples
--------
python -m aloception_tpu_torch.commands.train_on_coco --cpu --sample --tiny --fast_dev_run
python -m aloception_tpu_torch.commands.train_on_coco --model deformable --sample \
    --batch_size 8 --size 640 640 --max_steps 100
python -m aloception_tpu_torch.commands.train_on_coco --model panoptic_deformable --sample \
    --batch_size 4 --size 640 640 --max_steps 100
python -m aloception_tpu_torch.commands.train_on_coco --model deformable --multiscale \
    --batch_size 2 --max_steps 100
python -m aloception_tpu_torch.commands.train_on_coco --model deformable --sample --bf16 \
    --log tensorboard --batch_size 8 --size 640 640 --max_steps 100

``--model panoptic`` and ``--model panoptic_deformable`` train the panoptic
head on a frozen DETR-R50 or Deformable-DETR-R50 (without refinement), the
latter with the focal criterion and matcher as its base; validation reports
PQ for them and AP for the detectors.
Without ``--sample`` it reads COCO on disk (``train2017``, ``val2017``,
``annotations/instances_{train,val}2017.json``) from the directory that
``~/.aloception_tpu/alodataset_config.json`` names under "coco", its frames
made by ``--num_workers`` threads; ``--multiscale`` trains at the
reference's multi-scale geometry (shorter side 480-800, longer at most
1333, batches padded to ``MULTISCALE_BUCKETS``) instead of ``--size``.
``--bf16`` computes in bfloat16 over float32 master weights (the
criterion in float32); ``--log tensorboard`` writes an event file of the
train and validation metrics into the run's checkpoint directory.
Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises. ``--multihost`` starts the process group
(``parallel.init_multihost``: ``ALO_COORDINATOR_ADDRESS`` /
``ALO_NUM_PROCESSES`` / ``ALO_PROCESS_ID``, or torchrun's variables; NCCL
on the cards, gloo with ``--cpu``) before the mesh is built; each process
then steps its rows of every batch (DDP), and ``--tp N`` places the wide
Linears over N ranks::

    torchrun --nproc_per_node 2 -m aloception_tpu_torch.commands.train_on_coco \
        --cpu --sample --tiny --fast_dev_run --multihost
"""

from __future__ import annotations

import argparse

# flags of the JAX command that the port does not take, with their ROADMAP
# item
NOT_PORTED = {"steps_per_dispatch": "A12: the TPU's scan-blocked dispatch"}


def add_argparse_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--model", default="detr",
                   choices=["detr", "deformable", "panoptic",
                            "panoptic_deformable"])
    p.add_argument("--sample", action="store_true",
                   help="use the offline synthetic COCO sample")
    p.add_argument("--train_on_val", action="store_true")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--max_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--fast_dev_run", action="store_true",
                   help="2 train batches + 1 val batch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--project", default=None)
    p.add_argument("--expe_name", default="coco")
    p.add_argument("--run_id", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_dir", default=None,
                   help="experiment root (default ~/.aloception_tpu/"
                        "experiments via the alonet config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--multiscale", action="store_true",
                   help="reference multi-scale geometry (scales 480-800, "
                        "max 1333, bucketed padding) instead of --size")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 over float32 master weights")
    p.add_argument("--log", default=None, choices=[None, "tensorboard", "tb"],
                   help="write a TensorBoard event file into the run's "
                        "checkpoint directory")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel axis size")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group before building the mesh "
                        "(ALO_COORDINATOR_ADDRESS / ALO_NUM_PROCESSES / "
                        "ALO_PROCESS_ID, or torchrun's variables)")
    p.add_argument("--steps_per_dispatch", type=int, default=None)
    return p


def main(argv=None):
    args = add_argparse_args(argparse.ArgumentParser(__doc__)).parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported (ROADMAP {item})")
    if args.multihost:
        from aloception_tpu_torch.parallel import init_multihost
        init_multihost(device="cpu" if args.cpu else None)
    from aloception_tpu_torch.models.transformers import entry_device
    from aloception_tpu_torch.train import (
        ApMetricsCallback, CocoDetection2Detr, MetricsCallback,
        PQMetricsCallback, make_deformable_detr_trainer, make_detr_trainer,
        make_panoptic_trainer)

    device = entry_device("cpu" if args.cpu else None)
    panoptic = args.model.startswith("panoptic")
    dm = CocoDetection2Detr(batch_size=args.batch_size,
                            num_workers=args.num_workers,
                            train_on_val=args.train_on_val, sample=args.sample,
                            size=None if args.multiscale else tuple(args.size),
                            seed=args.seed, return_masks=panoptic)
    import torch
    kwargs = dict(data_module=dm, run_id=args.run_id,
                  expe_name=args.expe_name, device=device, seed=args.seed,
                  log=args.log, tp=args.tp,
                  dtype=torch.bfloat16 if args.bf16 else torch.float32,
                  callbacks=[MetricsCallback(), PQMetricsCallback()
                             if panoptic else ApMetricsCallback()])
    if args.project:
        kwargs["project"] = args.project
    if args.log_dir:
        kwargs["log_dir"] = args.log_dir
    if args.lr:
        kwargs["lr"] = args.lr
    if args.fast_dev_run:
        kwargs["limit_train_batches"] = 2
        kwargs["limit_val_batches"] = 1
        args.max_epochs = 1

    n_cls = len(dm.label_names)
    if args.tiny:
        from aloception_tpu_torch.models.deformable_detr import DeformableDETR
        from aloception_tpu_torch.models.detr import Detr
        tiny = dict(num_classes=n_cls, hidden_dim=64, num_queries=20,
                    nheads=4, num_encoder_layers=2, num_decoder_layers=2,
                    dim_feedforward=128, stage_sizes=(1, 1, 1, 1),
                    device=device)
        models = {
            "detr": lambda: Detr(**tiny),
            "deformable": lambda: DeformableDETR(with_box_refine=True,
                                                 **tiny),
            "panoptic": lambda: Detr(return_intermediate=True, **tiny),
            "panoptic_deformable": lambda: DeformableDETR(
                with_box_refine=False, return_intermediate=True, **tiny)}
        kwargs["detector" if panoptic else "model"] = models[args.model]()
    if panoptic:
        # the head trains on a frozen detector; the Deformable one has the
        # focal criterion and matcher as its base
        if args.model == "panoptic_deformable":
            from functools import partial
            from aloception_tpu_torch.models.deformable_detr import (
                deformable_criterion, deformable_detr_r50,
                focal_hungarian_match)
            from aloception_tpu_torch.models.panoptic import (
                panoptic_criterion)
            kwargs["criterion"] = partial(
                panoptic_criterion, base_criterion=deformable_criterion,
                matcher=focal_hungarian_match)
            if "detector" not in kwargs:
                kwargs["detector"] = deformable_detr_r50(
                    num_classes=n_cls, return_intermediate=True,
                    device=device)
        make = make_panoptic_trainer
    else:
        make = make_detr_trainer if args.model == "detr" \
            else make_deformable_detr_trainer
    trainer = make(**kwargs)
    trainer.fit(dm.train_dataloader(), dm.val_dataloader(),
                max_epochs=args.max_epochs, max_steps=args.max_steps,
                resume=args.resume)
    print(f"[train_on_coco] done: step={trainer.global_step} "
          f"val={trainer.last_val_metrics} ckpt={trainer.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
