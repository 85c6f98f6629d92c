"""The PyTorch port's detector training on the CPU: a tiny DETR's loss
falls on a repeated batch. Split from ``tests/test_torch_trainer.py`` (a
file of its own, so that the suite's workers, which take whole files, share
the load)."""

import numpy as np
import torch

from test_torch_trainer import tiny_detr


def test_loss_falls_on_a_repeated_batch():
    """~40 float32 steps on a 2-box scene cut the loss by more than 40 %
    and leave the two matched queries predicting distinct boxes."""
    from aloception_tpu_torch.models.detr.criterion import detr_criterion
    from aloception_tpu_torch.models.detr.matcher import hungarian_match
    from aloception_tpu_torch.train import TrainOptimizer, make_detr_train_step

    H = W = 64
    img = np.full((1, H, W, 3), 0.4, np.float32)
    img[0, 8:24, 4:28] = [0.9, 0.1, 0.1]
    img[0, 40:60, 36:60] = [0.1, 0.2, 0.9]
    targets = {"boxes": torch.tensor([[[16 / W, 16 / H, 24 / W, 16 / H],
                                       [48 / W, 50 / H, 24 / W, 20 / H]]]),
               "labels": torch.tensor([[0, 2]]),
               "valid": torch.tensor([[True, True]])}
    model = tiny_detr(4, dropout=0.0)
    opt = TrainOptimizer(model, lr=1e-3, lr_backbone=1e-3, grad_clip=0.1)
    step = make_detr_train_step(model, opt, detr_criterion)
    images, mask = torch.from_numpy(img), torch.zeros(1, H, W)
    losses = []
    for _ in range(41):
        keys, packed = step(images, mask, targets)
        losses.append(dict(zip(keys, packed.tolist()))["loss_total"])
    assert losses[-1] < 0.6 * losses[0], losses
    model.eval()
    with torch.no_grad():
        out = model(images, mask)
    (q0, q1), = hungarian_match(out, targets)[0].tolist()
    assert q0 != q1
    b0, b1 = out["pred_boxes"][0, q0], out["pred_boxes"][0, q1]
    assert (b0 - b1).abs().sum() > 0.1
