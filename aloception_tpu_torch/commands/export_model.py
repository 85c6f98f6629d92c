"""Export a model to an AOTInductor package (counterpart of
``aloception_tpu/commands/export_model.py``; reference:
alonet/detr/trt_exporter.py __main__ usage).

Examples
--------
python -m aloception_tpu_torch.commands.export_model --cpu --tiny --model detr --out /tmp/detr.pt2
python -m aloception_tpu_torch.commands.export_model --model deformable --out dd.pt2 --profile

The model is exported with ``torch.export`` at fixed shapes (``--batch_size``
images of ``--size``), compiled by AOTInductor into ``--out`` (a ``.pt2``
package with a ``.json`` sidecar), and the package is checked against the
eager model. ``deformable`` is Deformable-DETR-R50 with box refinement; its
package calls the MSDA operator, the hand-written CUDA kernel on the card.
Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises. Without ``--ckpt_dir`` the weights are random,
from a seeded generator.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Returns (the exporter, the profile report or None): the exporter's
    ``artifact`` is the package written to ``--out``, its ``executor`` the
    package loaded for the sanity check, for a caller to run on."""
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--model", default="detr",
                   choices=["detr", "deformable", "raft"])
    p.add_argument("--out", required=True)
    p.add_argument("--precision", default="fp32",
                   choices=["fp32", "bf16", "fp16"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--ckpt_dir", default=None,
                   help="restore the model of a checkpoint saved by the "
                        "port's trainer")
    p.add_argument("--best", action="store_true",
                   help="with --ckpt_dir: the best checkpoint, not the last")
    p.add_argument("--num_classes", type=int, default=91)
    p.add_argument("--iters", type=int, default=12, help="raft iterations")
    p.add_argument("--no_sanity", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    import torch
    from aloception_tpu_torch.export import (DeformableDetrExporter,
                                             DetrExporter, RAFTExporter)
    from aloception_tpu_torch.models.transformers import entry_device

    device = entry_device("cpu" if args.cpu else None)
    tiny = dict(hidden_dim=64, num_queries=16, nheads=4,
                num_encoder_layers=1, num_decoder_layers=1,
                dim_feedforward=64, stage_sizes=(1, 1, 1, 1))
    h, w = args.size
    if args.model == "detr":
        from aloception_tpu_torch.models.detr import Detr, detr_r50
        model = Detr(num_classes=args.num_classes, device=device,
                     **tiny).eval() if args.tiny \
            else detr_r50(num_classes=args.num_classes, device=device)
        exporter_cls = DetrExporter
    elif args.model == "deformable":
        from aloception_tpu_torch.models.deformable_detr import (
            DeformableDETR, deformable_detr_r50)
        model = DeformableDETR(num_classes=args.num_classes,
                               with_box_refine=True, device=device,
                               **tiny).eval() if args.tiny \
            else deformable_detr_r50(num_classes=args.num_classes,
                                     with_box_refine=True, device=device)
        exporter_cls = DeformableDetrExporter
    else:
        from aloception_tpu_torch.models.raft import RAFTBase, built, raft
        model = built(RAFTBase(hidden_dim=32, context_dim=32, corr_levels=2,
                               corr_radius=2, device=device),
                      torch.float32) if args.tiny else raft(device=device)
        exporter_cls = RAFTExporter

    if args.ckpt_dir:
        from aloception_tpu_torch.train import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir)
        model.load_state_dict(ckpt.restore_tree(best=args.best)["model"])
        print(f"[export] restored "
              f"{'best' if args.best else 'last'} checkpoint")

    kwargs = dict(precision=args.precision, batch_size=args.batch_size,
                  input_shape=(h, w))
    if args.model == "raft":
        kwargs["iters"] = args.iters
    exporter = exporter_cls(model, **kwargs)
    exporter.export_engine(path=args.out, sanity_check=not args.no_sanity)
    print(f"[export] wrote {args.out} "
          f"({os.path.getsize(args.out) // 1024} KB, {args.precision})")
    report = None
    if args.profile:
        report = exporter.profile(n_iters=5)
        print("[export] profile:", report)
    return exporter, report


if __name__ == "__main__":
    main()
