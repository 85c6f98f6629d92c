"""Evaluate RAFT's end-point error on Sintel (counterpart of
``aloception_tpu/commands/eval_on_sintel.py``).

Examples
--------
python -m aloception_tpu_torch.commands.eval_on_sintel --cpu --sample --tiny --limit_samples 2
python -m aloception_tpu_torch.commands.eval_on_sintel --weights raft-things

Reads the clean pass of Sintel's ``training/`` folder from the directory
that the dataset config (``~/.aloception_tpu/alodataset_config.json``, key
"Sintel") names, decoded by two threads ahead of the model; ``--sample``
reads the offline synthetic sample instead. Each pair of frames goes Frame
-> ``norm_minmax_sym`` -> ``Padder`` (to a multiple of 8) -> RAFT
(``only_last``) -> ``unpad``, and its EPE is the mean over pixels of the
flow's distance to the ground truth. Runs on the CUDA card, or on the CPU
with ``--cpu``; without a card and without ``--cpu`` it raises.
``--weights`` takes a registry name (``raft-things``, ``raft-chairs``,
``raft-sintel``, ``raft-kitti``, ``raft-small``: the published file dropped
into ``~/.aloception_tpu/weights``) or a path. Without ``--weights`` or
``--ckpt_dir`` the weights are random, from a seeded generator.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> float:
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--sample", action="store_true",
                   help="read the offline synthetic sample, not the Sintel "
                        "directory")
    p.add_argument("--small", action="store_true", help="RAFT-small")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--ckpt_dir", default=None,
                   help="restore the model of a checkpoint saved by the "
                        "port's trainer")
    p.add_argument("--weights", default=None,
                   help="a registry name (e.g. raft-things: the file under "
                        "~/.aloception_tpu/weights) or the path of a local "
                        "reference RAFT state_dict; nothing is fetched")
    p.add_argument("--best", action="store_true",
                   help="with --ckpt_dir: the best checkpoint, not the last")
    p.add_argument("--limit_samples", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    import torch
    from aloception_tpu_torch.alodataset import SintelFlowDataset, Split
    from aloception_tpu_torch.models.raft import (Padder, RAFTBase, built,
                                                  raft, raft_small)
    from aloception_tpu_torch.models.transformers import entry_device

    device = entry_device("cpu" if args.cpu else None)
    if args.tiny:
        model = built(RAFTBase(hidden_dim=32, context_dim=32, corr_levels=2,
                               corr_radius=2, device=device), torch.float32)
    else:
        model = (raft_small if args.small else raft)(device=device)
    if args.weights:
        from aloception_tpu_torch.utils.weights import load_weights
        load_weights(model, args.weights)
        print(f"[eval] loaded weights {args.weights}")
    elif args.ckpt_dir:
        from aloception_tpu_torch.train import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir)
        model.load_state_dict(ckpt.restore_tree(best=args.best)["model"])
        print(f"[eval] restored step "
              f"{ckpt.best_step() if args.best else ckpt.last_step()}")

    ds = SintelFlowDataset(sample=args.sample, split=Split.TRAIN,
                           sequence_size=2)
    epes = []
    for i, frames in enumerate(ds.stream_loader(num_workers=2)):
        if args.limit_samples and i >= args.limit_samples:
            break
        frames = frames.to(device).norm_minmax_sym()
        flow_slot = frames[0].get_child("flow")
        if isinstance(flow_slot, dict):
            flow_slot = next(iter(flow_slot.values()))
        if flow_slot is None:
            continue
        f1, f2 = (frames[t].as_layout(("C", "H", "W"))[None] for t in (0, 1))
        padder = Padder(f1.shape)
        with torch.inference_mode():
            flow = padder.unpad(model(*padder.pad(f1, f2), iters=args.iters,
                                      only_last=True))[0]
        epes.append((flow - flow_slot.array).pow(2).sum(0).sqrt().mean())

    mean_epe = torch.stack(epes).mean().item() if epes else float("nan")
    print(f"[eval_on_sintel] EPE={mean_epe:.3f} over {len(epes)} pairs")
    return mean_epe


if __name__ == "__main__":
    main()
