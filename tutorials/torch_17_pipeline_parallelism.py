"""Tutorial 17 (PyTorch port) — pipeline parallelism: a transformer layer
stack as GPipe stages over the mesh's ``pp`` axis
(``aloception_tpu_torch/parallel/pipeline.py``). The port of
``17_pipeline_parallelism.py``.

The reference scales only by DDP replication; a deep homogeneous stack
(DETR's 6 encoder layers) can also be split across devices: each rank
holds a contiguous slice of the stacked per-layer parameters, and the
activations go stage to stage by send and receive, one microbatch per tick.
Autograd runs straight through the pipeline (each hand-over's gradient
goes back the other way), so the same call trains.

The 8 ranks (dp 4 x pp 2) are spawned by ``parallel.dryrun.spawn`` on the
gloo backend, on the CPU or all on the one CUDA card (NCCL binds a rank to
a card of its own; gloo takes the card's tensors through the host).

Runs on the CUDA card; ``main("cpu")`` (or ``--cpu``) runs the ranks on the
CPU.

Run: python tutorials/torch_17_pipeline_parallelism.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def rank_main(rank, n, device_type):
    """One rank (``parallel.dryrun.spawn`` calls it): the pipelined forward
    of its rows against the sequential stack, and the pipelined gradient's
    global norm."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from aloception_tpu_torch.models.detr.transformer import EncoderLayer
    from aloception_tpu_torch.parallel import (gpipe, make_mesh, mesh_shape,
                                               shard_batch,
                                               shard_layer_stack,
                                               stack_layer_params)
    from aloception_tpu_torch.parallel.mesh import axis_group

    device = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    say = print if rank == 0 else (lambda *a: None)

    # --- 1) a 4-layer encoder stack, its parameters STACKED on a layer axis
    layers = []
    for i in range(4):
        torch.manual_seed(i)
        layers.append(EncoderLayer(d_model=64, nheads=4, dim_feedforward=128,
                                   dropout=0.0, device=device))
    stacked = stack_layer_params(layers)   # leaves gain a leading (4,) axis
    rng = np.random.RandomState(0)
    B, L, D = 8, 24, 64
    x = torch.from_numpy(rng.randn(B, L, D).astype(np.float32))
    pos = torch.from_numpy(rng.randn(B, L, D).astype(np.float32))
    mask = torch.zeros(B, L, dtype=torch.bool)

    # --- 2) a mesh with a pipeline axis: dp=4 x pp=2 (2 layers a stage)
    mesh = make_mesh(pp=2)
    say("mesh:", mesh_shape(mesh))
    local = shard_layer_stack(stacked, mesh)   # each rank holds its stage
    x, pos, mask = (t.to(device) for t in shard_batch([x, pos, mask], mesh))

    # --- 3) the pipelined forward: the same numerics, staged execution
    def apply_one(p, act, extras):
        return functional_call(layers[0], p, (act, extras["pos"],
                                              extras["mask"]))

    out = gpipe(apply_one, local, x, {"pos": pos, "mask": mask}, mesh,
                n_micro=2)
    with torch.no_grad():
        seq = x
        for layer in layers:
            seq = layer(seq, pos, mask)
        maxdiff = (out.detach() - seq).abs().max()
    dist.all_reduce(maxdiff, op=dist.ReduceOp.MAX)
    say("pipeline vs sequential maxdiff:", float(maxdiff))

    # --- 4) and it TRAINS: the gradient of the global batch's mean
    # square, each stage's summed over dp, its norm over the stages
    loss = (out ** 2).sum() / (B * L * D)
    loss.backward()
    grads = [t.grad for t in local.values()]
    for g in grads:
        dist.all_reduce(g, group=axis_group(mesh, "dp"))
    sq = torch.stack([g.pow(2).sum() for g in grads]).sum()
    dist.all_reduce(sq, group=axis_group(mesh, "pp"))
    gnorm = float(sq.sqrt())
    say("pipelined grad norm:", round(gnorm, 4))
    say("\nGPipe bubble: (S-1)/(M+S-1) idle fraction; raise n_micro to "
        "amortize it. Each rank stores only its stage's layers (pairs with "
        "FSDP over dp for the rest of the model).")
    return {"maxdiff": float(maxdiff), "grad_norm": gnorm}


def main(device=None):
    """Spawns the 8 ranks; returns rank 0's result."""
    from aloception_tpu_torch.models.transformers import entry_device
    from aloception_tpu_torch.parallel.dryrun import spawn
    device = entry_device(device)
    return spawn(8, rank_main, device.type, device=device.type,
                 backend="gloo", timeout=600)[0]


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv else None)
