"""Evaluate DETR-family detectors and their panoptic heads on COCO
(counterpart of ``aloception_tpu/commands/eval_on_coco.py``): box AP for
every model, and panoptic quality (PQ, SQ, RQ) for the panoptic ones.

Examples
--------
python -m aloception_tpu_torch.commands.eval_on_coco --cpu --sample --tiny --model panoptic --limit_batches 1 --size 96 128
python -m aloception_tpu_torch.commands.eval_on_coco --sample --model panoptic_deformable --limit_batches 2
python -m aloception_tpu_torch.commands.eval_on_coco --model deformable --multiscale --limit_batches 10

Each batch goes through the data module (resize to ``--size``,
``norm_resnet``, ``batch_list``) -> the model -> ``inference`` (for the
panoptic models ``inference_with_masks``, the masks upsampled to the batch's
padded size) -> ``ApMetrics`` and ``PQMetrics``. The softmax models keep
queries of a class other than the background one scoring over
``--threshold``; the sigmoid ones (Deformable-DETR) over max(threshold,
0.2). Runs on the CUDA card, or on the CPU with ``--cpu``; without a card
and without ``--cpu`` it raises. Without ``--sample`` it reads COCO's
``val2017`` on disk from the directory that
``~/.aloception_tpu/alodataset_config.json`` names under "coco".
``--multiscale`` (a flag the JAX command lacks) resizes to a shorter side of
800, longer at most 1333, and pads each batch to its multi-scale bucket,
instead of resizing to ``--size``. ``--weights`` takes a registry name
(``detr-r50``, ``deformable-detr-r50[-refinement]``, ``detr-r50-panoptic``:
the published file dropped into ``~/.aloception_tpu/weights``) or a path;
the reference publishes no Deformable panoptic checkpoint, so
``--model panoptic_deformable --weights <name>`` exits (a path still
loads). Without ``--weights``,
``--ckpt_dir`` or ``--run_id`` the weights are random, from a seeded
generator.
"""

from __future__ import annotations

import argparse
import os

# the --tiny models' widths and depths, the JAX command's
TINY = dict(hidden_dim=64, num_queries=20, nheads=4, num_encoder_layers=2,
            num_decoder_layers=2, dim_feedforward=128,
            stage_sizes=(1, 1, 1, 1))


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--model", default="detr",
                   choices=["detr", "deformable", "panoptic",
                            "panoptic_deformable"])
    p.add_argument("--sample", action="store_true",
                   help="use the offline synthetic COCO sample")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--multiscale", action="store_true",
                   help="shorter side 800, longer at most 1333, batches "
                        "padded to their multi-scale bucket")
    p.add_argument("--ckpt_dir", default=None,
                   help="restore the model of a checkpoint saved by the "
                        "port's trainer")
    p.add_argument("--run_id", default=None,
                   help="resolve --ckpt_dir from a train run's run_id")
    p.add_argument("--project", default=None,
                   help="narrow --run_id resolution to one project")
    p.add_argument("--log_dir", default=None,
                   help="experiment root for --run_id resolution")
    p.add_argument("--best", action="store_true",
                   help="with --ckpt_dir: the best checkpoint, not the last")
    p.add_argument("--weights", default=None,
                   help="a registry name (utils.weights.WEIGHT_REGISTRY, "
                        "e.g. detr-r50: the file under "
                        "~/.aloception_tpu/weights) or the path of a local "
                        "state_dict under the reference names; nothing is "
                        "fetched")
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--tiny", action="store_true",
                   help="tiny models for smoke runs")
    args = p.parse_args(argv)

    import torch
    from aloception_tpu_torch.metrics import ApMetrics, PQMetrics
    from aloception_tpu_torch.models import deformable_detr as dd
    from aloception_tpu_torch.models import detr
    from aloception_tpu_torch.models.panoptic import (DetrPanoptic,
                                                      inference_with_masks)
    from aloception_tpu_torch.models.transformers import entry_device
    from aloception_tpu_torch.train import CocoDetection2Detr

    device = entry_device("cpu" if args.cpu else None)
    if args.run_id and not args.ckpt_dir:
        from aloception_tpu_torch.train import find_run_dir
        args.ckpt_dir = find_run_dir(args.run_id, project=args.project,
                                     log_dir=args.log_dir)
        print(f"[eval] run_id {args.run_id} -> {args.ckpt_dir}")

    panoptic = args.model.startswith("panoptic")
    deformable = args.model in ("deformable", "panoptic_deformable")
    dm = CocoDetection2Detr(batch_size=args.batch_size,
                            num_workers=args.num_workers, sample=args.sample,
                            size=None if args.multiscale else tuple(args.size),
                            return_masks=panoptic)
    n_cls = len(dm.label_names) if dm.label_names else 91

    kwargs = dict(num_classes=n_cls, device=device)
    if panoptic:
        kwargs["return_intermediate"] = True
    if deformable:
        # the published 'deformable-detr-r50' (no suffix) is the checkpoint
        # without refinement; the panoptic head wraps that one
        kwargs["with_box_refine"] = args.model == "deformable" and not (
            args.weights and "deformable" in args.weights
            and "refinement" not in args.weights)
    if args.tiny:
        detector = (dd.DeformableDETR if deformable else detr.Detr)(
            **TINY, **kwargs).eval()
    elif deformable:
        detector = dd.deformable_detr_r50(**kwargs)
    else:
        detector = None if panoptic else detr.detr_r50(**kwargs)
    if panoptic:
        model = DetrPanoptic(detector, num_classes=n_cls, device=device)
        activation = "sigmoid" if deformable else "softmax"
        threshold = max(args.threshold, 0.2) if deformable else args.threshold

        def inference(out, frame_size):
            return inference_with_masks(out, threshold=threshold,
                                        background_class=n_cls,
                                        activation_fn=activation,
                                        frame_size=frame_size)
    elif deformable:
        model = detector

        def inference(out, frame_size):
            return dd.inference(out, threshold=max(args.threshold, 0.2))
    else:
        model = detector

        def inference(out, frame_size):
            return detr.inference(out, threshold=args.threshold,
                                  background_class=n_cls)

    if args.weights:
        if args.model == "panoptic_deformable" \
                and not os.path.exists(args.weights):
            # a registry name: a local state_dict of one's own still loads
            raise SystemExit("--weights: the reference publishes no "
                             "deformable-panoptic checkpoint")
        from aloception_tpu_torch.utils.weights import load_weights
        load_weights(model, args.weights)
        print(f"[eval] loaded weights {args.weights}")
    elif args.ckpt_dir:
        from aloception_tpu_torch.train import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir)
        model.load_state_dict(ckpt.restore_tree(best=args.best)["model"])
        print(f"[eval] restored step "
              f"{ckpt.best_step() if args.best else ckpt.last_step()}")

    num_queries = (model.detr if panoptic else model).num_queries
    dm.max_targets = min(dm.max_targets, num_queries)
    metrics = ApMetrics()
    pq_metrics = PQMetrics() if panoptic else None
    for i, frames_list in enumerate(dm.val_dataloader()):
        if args.limit_batches and i >= args.limit_batches:
            break
        prepared = dm.prepare_batch(frames_list, training=False)
        images, mask = (x.to(device) for x in prepared["inputs"])
        with torch.inference_mode():
            preds = inference(model(images, mask), tuple(images.shape[1:3]))
        frames = prepared["frames"]
        gt_boxes = frames.boxes2d if isinstance(frames.boxes2d, list) \
            else [frames.boxes2d]
        if panoptic:
            segs = frames.segmentation
            for (pb, pm), tb, seg in zip(preds, gt_boxes, segs):
                if tb is not None:
                    metrics.add_sample(pb, tb)
                if seg is not None and not isinstance(seg, dict):
                    pq_metrics.add_sample(pm, seg)
        else:
            for pb, tb in zip(preds, gt_boxes):
                if tb is not None:
                    metrics.add_sample(pb, tb)

    all_maps, _ = metrics.calc_map(print_result=True)
    if panoptic:
        pq_all = pq_metrics.pq_average(isthing=None, print_result=True)
        pq_metrics.pq_average(isthing=True, print_result=True)
        pq_metrics.pq_average(isthing=False, print_result=True)
        print(f"[eval_on_coco] PQ={pq_all['pq']:.3f} SQ={pq_all['sq']:.3f} "
              f"RQ={pq_all['rq']:.3f}")
    print(f"[eval_on_coco] AP={all_maps['all']['all']:.2f} "
          f"AP50={all_maps['all'][50]:.2f}")
    return all_maps


if __name__ == "__main__":
    main()
