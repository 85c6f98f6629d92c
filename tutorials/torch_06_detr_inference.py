"""Tutorial 6 (PyTorch port) — DETR inference end to end: Frame ->
batch_list -> forward -> aloscene boxes -> render. The port of
``06_detr_inference.py``; compare the reference's
tutorials/5.1-detrmod_coco_.py.

The inference contract is the reference's (alonet/detr/detr.py:315): the
model returns a dict of tensors, ``inference()`` turns it back into
aloscene ``BoundingBoxes2D`` + ``Labels`` with scores, and those attach to
the input frame for rendering: the type system closes the loop.

Runs on the CUDA card; ``main("cpu")`` (or ``--cpu``) runs it on the CPU.

Run: python tutorials/torch_06_detr_inference.py [--cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main(device=None, out_dir=None):
    """Returns the boxes kept for each frame."""
    import torch

    from aloception_tpu_torch import aloscene
    from aloception_tpu_torch.aloscene import Frame
    from aloception_tpu_torch.models.detr import Detr, inference
    from aloception_tpu_torch.models.transformers import entry_device

    device = entry_device(device)
    # a tiny DETR so that the demo runs in seconds; swap for
    # detr_r50(num_classes=91) + utils.weights.load_weights(model,
    # "detr-r50") with the reference checkpoint in ~/.aloception_tpu/weights
    model = Detr(num_classes=10, hidden_dim=64, num_queries=20, nheads=4,
                 num_encoder_layers=2, num_decoder_layers=2,
                 dim_feedforward=128, stage_sizes=(1, 1, 1, 1),
                 device=device).eval()

    # 1) frames of DIFFERENT sizes, as they come from any dataset
    rng = np.random.RandomState(0)
    frames = [Frame(torch.from_numpy(
        rng.uniform(0, 255, (3, h, w)).astype(np.float32)).to(device))
        for h, w in ((96, 128), (80, 112))]

    # 2) normalize to what the model asserts, pad into one batch + its mask
    batch = aloscene.batch_list([f.norm_resnet() for f in frames])
    images = batch.as_layout(("B", "H", "W", "C"))
    pad_mask = batch.mask.array[:, 0]

    # 3) the forward
    with torch.inference_mode():
        outputs = model(images, pad_mask)
    print("pred_logits", tuple(outputs["pred_logits"].shape),
          "pred_boxes", tuple(outputs["pred_boxes"].shape))

    # 4) back into the aloscene type system
    boxes_per_frame = inference(outputs, threshold=0.05, background_class=10)
    for frame, boxes in zip(frames, boxes_per_frame):
        frame.append_boxes2d(boxes)
        scores = boxes.get_child("labels").scores[:3].cpu().numpy()
        print(f"frame {frame.HW}: kept {boxes.shape[0]} boxes, "
              f"scores {np.round(scores, 3)}")

    # 5) render (to a file here; .render() would open a window)
    out = os.path.join(out_dir or tempfile.gettempdir(),
                       "alo_tutorial06.png")
    frames[0].get_view().save(out)
    print("wrote", out)
    return boxes_per_frame


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv else None)
