"""Panoptic training of the PyTorch port against the JAX package on the CPU:
``dice_loss``, ``focal_mask_loss`` and ``loss_masks`` (padded targets,
masks resized by ratios that are not 2), ``panoptic_criterion`` on the tiny
``DetrPanoptic`` with the DETR base and with the Deformable base and the
focal matcher (losses, matched queries and the head's gradients against
``jax.value_and_grad``; the JAX Deformable-DETR runs its Pallas MSDA kernel
in interpret mode), the panoptic batch's masks, the AP and PQ callbacks on
the same outputs and batch, and a replay of the JAX package's
``test_panoptic_train_step_learns`` (the mask loss falls by a quarter in 60
steps on a frozen detector that no step moves). Inputs are drawn with numpy;
the JAX side runs at HIGHEST matmul precision.

Tolerances: the mask losses 1e-5 relative (one elementwise pass and a sum);
the criterion's losses 1e-4 relative (float32 through the tiny model's
layers); each head gradient 1e-3 of its tensor's largest magnitude, or
1e-6 of the head's largest where a tensor's gradients are near 0 (the
biases of convolutions that a GroupNorm follows); matched queries equal;
batch masks 1e-6; AP and PQ to 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models.deformable_detr import criterion as jdc
from aloception_tpu.models.detr import matcher as jmatch
from aloception_tpu.models.panoptic import criterion as jpc
from aloception_tpu_torch.models.deformable_detr import criterion as tdc
from aloception_tpu_torch.models.detr import matcher as tmatch
from aloception_tpu_torch.models.panoptic import criterion as tpc
from aloception_tpu_torch.train.step import to_float32
from aloception_tpu_torch.utils.weights import panoptic_head_state_dict_from_jax

from test_torch_panoptic import TINY, _inputs, panoptic_pair
from torch_parity import t

NT, N_VALID = 6, (3, 0)        # padded targets and an image with none


def rel(got, want, tol, tag=""):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (tag, got, want)


def mask_case(seed, n, hw, thw):
    """Mask logits (n, *hw), soft targets (n, *thw) in [0, 1] with exact 0s
    and 1s, valid (n,) with the last third invalid."""
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(n, *hw)).astype(np.float32)
    tgt = np.clip(rng.uniform(-0.5, 1.5, (n, *thw)), 0, 1).astype(np.float32)
    valid = (np.arange(n) < n - n // 3).astype(np.float32)
    return logits, tgt, valid


@pytest.mark.parametrize("loss", ["dice_loss", "focal_mask_loss"])
def test_mask_losses_match_jax(loss):
    logits, tgt, valid = mask_case(0, 9, (13, 17), (13, 17))
    want = getattr(jpc, loss)(logits, tgt, valid, 5.0)
    got = getattr(tpc, loss)(t(logits), t(tgt), t(valid), torch.tensor(5.0))
    rel(got, want, 1e-5, loss)


def targets_case(seed, thw):
    """Padded targets (B=2, NT) with soft masks at ``thw``, valid first."""
    rng = np.random.RandomState(seed)
    valid = np.arange(NT)[None] < np.asarray(N_VALID)[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (2, NT, 2)),
                            rng.uniform(0.1, 0.4, (2, NT, 2))], -1)
    masks = np.clip(rng.uniform(-0.5, 1.5, (2, NT, *thw)), 0, 1)
    return {"boxes": (boxes * valid[..., None]).astype(np.float32),
            "labels": rng.randint(0, TINY["num_classes"], (2, NT)) * valid,
            "valid": valid,
            "masks": (masks * valid[..., None, None]).astype(np.float32)}


def jax_targets(tg):
    return {"boxes": jnp.asarray(tg["boxes"]),
            "labels": jnp.asarray(tg["labels"], jnp.int32),
            "valid": jnp.asarray(tg["valid"]),
            "masks": jnp.asarray(tg["masks"])}


def torch_targets(tg):
    return {"boxes": t(tg["boxes"]),
            "labels": torch.from_numpy(tg["labels"]).long(),
            "valid": torch.from_numpy(tg["valid"]),
            "masks": t(tg["masks"])}


@pytest.mark.parametrize("thw", [(61, 83), (26, 34)],
                         ids=["down-4.7x", "up-0.96x"])
def test_loss_masks_matches_jax(thw):
    """Target masks resized to 13x17 by nearest sampling at half-pixel
    centres; an invalid target's matched index (-1 in the port, anything in
    JAX) reads query 0 and weighs 0."""
    rng = np.random.RandomState(3)
    pred = (3 * rng.randn(2, 8, 13, 17)).astype(np.float32)
    tg = targets_case(4, thw)
    matched = np.where(tg["valid"], rng.permutation(8)[:NT][None], -1)
    want = jpc.loss_masks(pred, jnp.asarray(tg["masks"]), jax_targets(tg),
                          jnp.asarray(matched), 3.0)
    got = tpc.loss_masks(t(pred), t(tg["masks"]), torch_targets(tg),
                         torch.from_numpy(matched).long(), torch.tensor(3.0))
    for g, w, name in zip(got, want, ("dice", "focal")):
        rel(g, w, 1e-5, name)


# kind: (JAX criterion, port criterion, JAX matcher, port matcher)
CRITERIA = {
    "detr": (jpc.panoptic_criterion, tpc.panoptic_criterion,
             jmatch.hungarian_match, tmatch.hungarian_match),
    "deformable": (
        lambda o, tg: jpc.panoptic_criterion(
            o, tg, base_criterion=jdc.deformable_criterion,
            matcher=jdc.focal_hungarian_match),
        lambda o, tg: tpc.panoptic_criterion(
            o, tg, base_criterion=tdc.deformable_criterion,
            matcher=tdc.focal_hungarian_match),
        jdc.focal_hungarian_match, tdc.focal_hungarian_match),
}


@pytest.mark.parametrize("kind", sorted(CRITERIA))
def test_panoptic_criterion_and_head_gradients_match_jax(kind):
    """The tiny DetrPanoptic (frozen detector, eval mode) on a padded
    100x132 batch: every metric of the criterion, the final layer's matched
    queries and the gradient of every head parameter; the frozen detector
    takes none."""
    jcrit, tcrit, jmatcher, tmatcher = CRITERIA[kind]
    jm, params, port = panoptic_pair(kind, seed=8)
    images, mask = _inputs(9)
    tg = targets_case(10, images.shape[1:3])

    def loss_fn(head):
        out = jm.apply({"params": {**params, "panoptic_head": head}},
                       images, mask)
        loss, metrics = jcrit(out, jax_targets(tg))
        return loss, (metrics, jmatcher(out, jax_targets(tg))[0])

    with jax.default_matmul_precision("highest"):
        (_, (want, want_matched)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params["panoptic_head"])
    want_grads = panoptic_head_state_dict_from_jax(jax.device_get(jgrads))

    out = to_float32(port(t(images), t(mask)))
    loss, got = tcrit(out, torch_targets(tg))
    loss.backward()
    matched, _ = tmatcher(out, torch_targets(tg))

    assert set(got) == set(want)
    for k in want:
        rel(got[k], want[k], 1e-4, k)
    valid = tg["valid"]
    assert np.array_equal(matched.numpy()[valid],
                          np.asarray(want_matched)[valid])
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(want_grads)
    assert all(p.grad is None for p in port.detr.parameters())
    top = max(float(g.abs().max()) for g in want_grads.values())
    for n, ref in want_grads.items():
        ref = ref.numpy()
        err = np.abs(grads[n].numpy() - ref).max()
        assert err <= max(1e-3 * np.abs(ref).max(), 1e-6 * top), (n, err)


def test_panoptic_batch_masks_match_jax():
    """The panoptic prepare adds (B, Nt, H, W) masks aligned with the
    padded targets, zeros past each frame's objects."""
    from aloception_tpu.train import CocoDetection2Detr as JaxDM
    from aloception_tpu.train.trainers import _make_panoptic_prepare as jprep
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train.trainers import (
        _make_panoptic_prepare as tprep)
    kw = dict(batch_size=2, sample=True, size=(96, 128), return_masks=True)
    jdm, tdm = JaxDM(**kw), CocoDetection2Detr(**kw)
    jdm.max_targets = tdm.max_targets = 7
    want = jprep(jdm)(next(iter(jdm.val_dataloader())), training=False)
    got = tprep(tdm)(next(iter(tdm.val_dataloader())), training=False)
    masks = got["targets"]["masks"]
    assert masks.shape == (2, 7, 96, 128) and masks.dtype == torch.float32
    np.testing.assert_allclose(masks.numpy(), want["targets"]["masks"],
                               atol=1e-6)
    n = got["targets"]["valid"].sum(1)
    for b in range(2):
        assert float(masks[b, n[b]:].abs().max()) == 0.0
        assert float(masks[b, :n[b]].amax((1, 2)).min()) > 0.0


# ----------------------------------------------------------------------
# callbacks
# ----------------------------------------------------------------------
class Logger:
    def __init__(self):
        self.scalars = {}

    def log_scalars(self, values, step, prefix=""):
        self.scalars.update({prefix + k: v for k, v in values.items()})

    def log_scalar(self, name, value, step):
        self.scalars[name] = value


class FakeTrainer:
    def __init__(self, inference_fn):
        self.inference_fn = inference_fn
        self.logger = Logger()


def outputs_near_truth(frames_boxes, frames_masks, n_cls, seed):
    """Outputs of 2 images x 20 queries: the first queries copy each
    image's ground truth (boxes, a confident label, mask logits of +-4 at
    stride 4), the others random with low scores."""
    rng = np.random.RandomState(seed)
    B, NQ = len(frames_boxes), 20
    logits = rng.randn(B, NQ, n_cls + 1).astype(np.float32)
    logits[..., n_cls] += 2.0
    boxes = rng.uniform(0.2, 0.6, (B, NQ, 4)).astype(np.float32)
    masks = rng.randn(B, NQ, 24, 32).astype(np.float32) - 2.0
    for b, (bx, labels, mk) in enumerate(zip(frames_boxes, *frames_masks)):
        n = len(bx)
        boxes[b, :n] = bx + rng.uniform(-0.01, 0.01, bx.shape)
        logits[b, np.arange(n), labels] += 6.0
        masks[b, :n] = np.where(mk[:, 2::4, 2::4] > 0.5, 4.0, -4.0)
    return {"pred_logits": logits, "pred_boxes": boxes, "pred_masks": masks}


def test_ap_and_pq_callbacks_match_jax():
    """One validation pass of each package's AP and PQ callbacks on the
    same outputs and sample batch: the logged AP and PQ tables equal."""
    from functools import partial
    from aloception_tpu.models.detr import inference as jinfer
    from aloception_tpu.models.panoptic import inference_with_masks as jiwm
    from aloception_tpu.train import CocoDetection2Detr as JaxDM
    from aloception_tpu.train import callbacks as jcb
    from aloception_tpu_torch.models.detr import inference as tinfer
    from aloception_tpu_torch.models.panoptic import (
        inference_with_masks as tiwm)
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train import callbacks as tcb

    kw = dict(batch_size=2, sample=True, size=(96, 128), return_masks=True)
    jdm, tdm = JaxDM(**kw), CocoDetection2Detr(**kw)
    n_cls = len(tdm.label_names)
    jb = jdm.prepare_batch(next(iter(jdm.val_dataloader())), training=False)
    tb = tdm.prepare_batch(next(iter(tdm.val_dataloader())), training=False)
    frames = tb["frames"]
    out = outputs_near_truth(
        [b.as_array().numpy() for b in frames.boxes2d],
        ([b.labels.array.long().numpy() for b in frames.boxes2d],
         [m.array.numpy() for m in frames.segmentation]), n_cls, seed=11)

    logged = []
    for cbs, trainer, outputs, batch in (
            ((tcb.ApMetricsCallback(), tcb.PQMetricsCallback()),
             (FakeTrainer(partial(tinfer, background_class=n_cls)),
              FakeTrainer(partial(tiwm, background_class=n_cls))),
             {k: t(v) for k, v in out.items()}, tb),
            ((jcb.ApMetricsCallback(), jcb.PQMetricsCallback()),
             (FakeTrainer(partial(jinfer, background_class=n_cls)),
              FakeTrainer(partial(jiwm, background_class=n_cls))),
             out, jb)):
        for cb, tr in zip(cbs, trainer):
            cb.on_val_batch_end(tr, outputs, batch, {})
            cb.on_val_epoch_end(tr, 1)
        logged.append({**trainer[0].logger.scalars,
                       **trainer[1].logger.scalars})
    got, want = logged
    assert set(got) == set(want) and "val/PQ_all_pq" in got
    assert got["val/AP50"] > 50.0 and got["val/PQ_all_pq"] > 0.5
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ----------------------------------------------------------------------
# learning
# ----------------------------------------------------------------------
def test_panoptic_train_step_learns():
    """The JAX package's ``test_panoptic_train_step_learns`` on the port:
    a frozen tiny DETR (dropout 0) under the head, a fixed 2-object scene,
    AdamW lr 3e-3 with the detector frozen; the mask losses (DICE + focal)
    fall by more than a quarter in 60 steps and no detector parameter
    moves."""
    from aloception_tpu_torch.models.detr import Detr
    from aloception_tpu_torch.models.panoptic import DetrPanoptic
    from aloception_tpu_torch.train import TrainOptimizer, make_train_step

    H, W = 64, 64
    img = np.full((1, H, W, 3), 0.4, np.float32)
    img[0, 8:24, 4:28] = [0.9, 0.1, 0.1]
    img[0, 40:60, 36:60] = [0.1, 0.2, 0.9]
    masks = np.zeros((1, 2, H, W), np.float32)
    masks[0, 0, 8:24, 4:28] = 1
    masks[0, 1, 40:60, 36:60] = 1
    targets = {"boxes": t([[[16 / W, 16 / H, 24 / W, 16 / H],
                            [48 / W, 50 / H, 24 / W, 20 / H]]]),
               "labels": torch.tensor([[0, 2]]),
               "valid": torch.tensor([[True, True]]),
               "masks": t(masks)}
    detector = Detr(num_classes=4, hidden_dim=32, num_queries=8, nheads=4,
                    num_encoder_layers=1, num_decoder_layers=1,
                    dim_feedforward=64, stage_sizes=(1, 1, 1, 1),
                    return_intermediate=True, dropout=0.0, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    model = DetrPanoptic(detector, num_classes=4)
    det0 = {k: v.clone() for k, v in model.detr.state_dict().items()}
    opt = TrainOptimizer(model, lr=3e-3, lr_backbone=3e-3, weight_decay=1e-4,
                         grad_clip=0.1, freeze_prefixes=("detr",))
    assert all(not p.requires_grad for p in model.detr.parameters())
    step = make_train_step(model, opt, tpc.panoptic_criterion)
    losses = []
    for _ in range(61):
        keys, packed = step((t(img), None), targets)
        m = dict(zip(keys, packed.tolist()))
        losses.append(m["loss_DICE"] + m["loss_focal"])
    assert losses[-1] < 0.75 * losses[0], (losses[0], losses[-1])
    for k, v in model.detr.state_dict().items():
        assert torch.equal(v, det0[k]), k
