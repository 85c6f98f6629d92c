"""Tutorial 8 (PyTorch port) — optical flow with RAFT: recurrent
refinement, EPE, and the Flow label type. The port of
``08_raft_optical_flow.py``; compare the reference's alonet/raft/README.md.

RAFT correlates every pixel pair between two frames (one batched GEMM),
then refines a flow field with a convolutional GRU, one lookup of the
correlation pyramid a step.

Runs on the CUDA card; ``main("cpu")`` (or ``--cpu``) runs it on the CPU.

Run: python tutorials/torch_08_raft_optical_flow.py [--cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main(device=None, out_dir=None):
    """Returns the ``Flow`` label of the first frame (C, H, W)."""
    import torch

    from aloception_tpu_torch.aloscene import Frame
    from aloception_tpu_torch.models.raft import RAFTBase, built, inference
    from aloception_tpu_torch.models.transformers import entry_device

    device = entry_device(device)
    # --- a synthetic pair with KNOWN flow: frame2 = frame1 shifted 8 px
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 255, (3, 96, 136)).astype(np.float32)
    shift = 8
    img1 = base[:, :, :128]
    img2 = base[:, :, shift:shift + 128]   # img1's content `shift` px right

    # frames must be minmax_sym normalized for RAFT (the reference asserts
    # it)
    f1 = Frame(torch.from_numpy(img1).to(device)).norm_minmax_sym()
    f2 = Frame(torch.from_numpy(img2).to(device)).norm_minmax_sym()
    x1 = f1.as_layout(("C", "H", "W"))[None]
    x2 = f2.as_layout(("C", "H", "W"))[None]

    # --- a small RAFT (random init: a demo of the structure; load the
    # reference's weights with utils.weights.load_weights(model,
    # "raft-things") for real quality)
    model = built(RAFTBase(hidden_dim=64, context_dim=64, corr_levels=4,
                           corr_radius=3, device=device), torch.float32)
    with torch.inference_mode():
        flows = model(x1, x2, iters=6)
    print("per-iteration predictions:", len(flows),
          "each", tuple(flows[0].shape), "(B, 2, H, W)")

    # --- EPE against the known ground truth
    gt = torch.zeros(2, 96, 128, device=device)
    gt[0] = shift                           # img1's content found `shift`
    for it in (0, 2, 5):                    # px to the right
        epe = float((flows[it][0] - gt).pow(2).sum(0).sqrt().mean())
        print(f"  iter {it}: EPE {epe:6.2f} px   (random weights!)")

    # --- flow as an aloscene label
    flow_labels = inference(flows)
    f1.append_flow(flow_labels[0])
    out = os.path.join(out_dir or tempfile.gettempdir(),
                       "alo_tutorial08_flow.png")
    f1.flow.get_view().save(out)            # Middlebury colour wheel
    print("flow label:", tuple(f1.flow.shape), "->", out)
    return f1.flow


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv else None)
