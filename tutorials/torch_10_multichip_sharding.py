"""Tutorial 10 (PyTorch port) — multi-device training: a mesh, the
placements, and the same train step on every rank. The port of
``10_multichip_sharding.py`` (the reference's Lightning DDP flag,
alonet/common/pl_helpers.py:372).

The JAX package annotates the layouts and lets XLA insert the collectives.
Here every rank is a process of one ``torch.distributed`` group:
``make_mesh`` lays the 8 ranks out as dp 4 x tp 2, ``data_parallel``
places the model as the Trainer does (the wide Linears column-parallel
over tp as DTensors, the other parameters' gradients averaged over dp),
``shard_batch`` gives each rank its dp rows of the global batch, and the
one-process train step runs unchanged inside ``use_mesh``.

The 8 ranks are spawned by ``parallel.dryrun.spawn``: on the CPU over
gloo, on the cards over NCCL, one card a rank. Ranks cannot share a card
here: NCCL refuses two ranks on one card, and over gloo DTensor's
collectives on CUDA tensors (the tp Linears' gathers) end the process
(torch 2.11), so on a host with fewer than 8 cards the tutorial runs with
``--cpu``.

Runs on the CUDA cards; ``main("cpu")`` (or ``--cpu``) runs the ranks on
the CPU.

Run: python tutorials/torch_10_multichip_sharding.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def rank_main(rank, n, device_type):
    """One rank of the demo (``parallel.dryrun.spawn`` calls it): 3 train
    steps of a tiny DETR on dp4 x tp2; returns the global losses and a
    parameter's and the batch's placement."""
    import torch
    import torch.distributed as dist

    from aloception_tpu_torch.models.detr import Detr, detr_criterion
    from aloception_tpu_torch.parallel import (make_mesh, mesh_shape,
                                               shard_batch, use_mesh)
    from aloception_tpu_torch.parallel.shard import data_parallel
    from aloception_tpu_torch.train import TrainOptimizer
    from aloception_tpu_torch.train.step import make_train_step

    device = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    say = print if rank == 0 else (lambda *a: None)
    say("ranks:", dist.get_world_size(), "on", device_type)

    # --- 1) the mesh: dp=4 data-parallel x tp=2 tensor-parallel
    mesh = make_mesh(tp=2)
    say("mesh:", mesh_shape(mesh))

    # --- 2) an ordinary model + the global batch (the same on every rank)
    model = Detr(num_classes=10, hidden_dim=64, num_queries=20, nheads=4,
                 num_encoder_layers=2, num_decoder_layers=2,
                 dim_feedforward=512, stage_sizes=(1, 1, 1, 1),
                 device=device)
    B = mesh_shape(mesh)["dp"] * 2            # global batch, split over dp
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(B, 64, 64, 3).astype(np.float32))
    mask = torch.zeros(B, 64, 64)
    targets = {
        "boxes": torch.from_numpy(np.clip(rng.uniform(0.2, 0.8, (B, 8, 4)),
                                          0.05, 0.95).astype(np.float32)),
        "labels": torch.from_numpy(rng.randint(0, 10, (B, 8))).long(),
        "valid": torch.from_numpy(np.arange(8)[None]
                                  < rng.randint(1, 8, (B, 1)))}

    # --- 3) place the model, build the optimizer over the placed
    # parameters, run the SAME train step on this rank's rows
    forward, after_backward = data_parallel(model, mesh)
    step = make_train_step(forward, TrainOptimizer(model), detr_criterion,
                           after_backward=after_backward)
    (images, mask), targets = shard_batch(((images, mask), targets), mesh)
    images, mask = images.to(device), mask.to(device)
    targets = {k: v.to(device) for k, v in targets.items()}
    losses = []
    for i in range(3):
        with use_mesh(mesh):
            keys, packed = step((images, mask), targets)
        dist.all_reduce(packed)        # each rank's rows -> the global batch
        metrics = dict(zip(keys, (packed / dist.get_world_size()).tolist()))
        losses.append(metrics["loss_total"])
        say(f"step {i}: loss={metrics['loss_total']:.4f}")

    # --- 4) inspect a placement
    name = "transformer.encoder.layers.0.linear1.weight"
    p = model.get_parameter(name)
    placement = (f"{name}: {type(p).__name__} {list(p.placements)} over "
                 f"{p.device_mesh.mesh_dim_names}, local "
                 f"{tuple(p.to_local().shape)} of {tuple(p.shape)}")
    batch = f"rank {rank}: rows {tuple(images.shape)} of the global {B}"
    say("example param placement:", placement)
    say("batch placement:", batch)
    return {"losses": losses, "placement": placement, "batch": batch,
            "placements": [repr(pl) for pl in p.placements]}


def main(device=None):
    """Spawns the 8 ranks; returns rank 0's result."""
    import torch

    from aloception_tpu_torch.models.transformers import entry_device
    from aloception_tpu_torch.parallel.dryrun import spawn
    device = entry_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < 8:
        raise RuntimeError(
            f"dp4 x tp2 on the cards takes 8 cards, one a rank (this host "
            f"has {torch.cuda.device_count()}): run it with --cpu")
    return spawn(8, rank_main, device.type, device=device.type,
                 timeout=600)[0]


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv else None)
