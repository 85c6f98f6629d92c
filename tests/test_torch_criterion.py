"""Set criteria and matchers of the PyTorch port against the JAX package on
the CPU: ``detr_criterion`` and ``deformable_criterion`` (every metric key),
both matchers, the gradients with respect to the logits and boxes of every
decoder output, and ``targets_from_frames``. Model outputs and targets are
drawn with numpy and handed to both; the batch has auxiliary outputs, padded
targets and an image with no target."""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models.deformable_detr import criterion as jdc
from aloception_tpu.models.detr import criterion as jc
from aloception_tpu.models.detr import matcher as jm
from aloception_tpu_torch.models.deformable_detr import criterion as tdc
from aloception_tpu_torch.models.detr import criterion as tc
from aloception_tpu_torch.models.detr import matcher as tm
from aloception_tpu_torch.ops.hungarian import hungarian_torch

B, NQ, NT, N_AUX = 3, 20, 6, 2
N_VALID = (4, 0, 6)            # padded targets, an image with none, a full one


def make_case(seed: int, n_logits: int, n_labels: int):
    """(outputs: a list of (logits, boxes) numpy pairs, the final output
    first; targets as numpy arrays)."""
    rng = np.random.RandomState(seed)
    outs = []
    for _ in range(1 + N_AUX):
        logits = (2 * rng.randn(B, NQ, n_logits)).astype(np.float32)
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, NQ, 2)),
                                rng.uniform(0.05, 0.4, (B, NQ, 2))],
                               -1).astype(np.float32)
        outs.append((logits, boxes))
    valid = np.arange(NT)[None] < np.asarray(N_VALID)[:, None]
    tboxes = np.concatenate([rng.uniform(0.2, 0.8, (B, NT, 2)),
                             rng.uniform(0.05, 0.4, (B, NT, 2))],
                            -1).astype(np.float32) * valid[..., None]
    labels = rng.randint(0, n_labels, (B, NT)) * valid
    return outs, {"boxes": tboxes, "labels": labels, "valid": valid}


def jax_outputs(outs):
    to = [{"pred_logits": jnp.asarray(l), "pred_boxes": jnp.asarray(b)}
          for l, b in outs]
    return {**to[0], "aux_outputs": to[1:]}


def torch_outputs(outs, requires_grad=False):
    to = [{"pred_logits": torch.tensor(l, requires_grad=requires_grad),
           "pred_boxes": torch.tensor(b, requires_grad=requires_grad)}
          for l, b in outs]
    return {**to[0], "aux_outputs": to[1:]}


def jax_targets(t):
    return {"boxes": jnp.asarray(t["boxes"]),
            "labels": jnp.asarray(t["labels"], jnp.int32),
            "valid": jnp.asarray(t["valid"])}


def torch_targets(t):
    return {"boxes": torch.from_numpy(t["boxes"]),
            "labels": torch.from_numpy(t["labels"]).long(),
            "valid": torch.from_numpy(t["valid"])}


# name: (JAX criterion, port criterion, logits width, label range)
CRITERIA = {
    "detr": (jc.detr_criterion, tc.detr_criterion, 6, 5),
    "deformable": (jdc.deformable_criterion, tdc.deformable_criterion, 5, 5),
}


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_metrics_match_jax(name):
    """Every metric key, the aux layers' included: the same float32
    arithmetic in another order, so 1e-5 relative."""
    jfn, tfn, n_logits, n_labels = CRITERIA[name]
    outs, targets = make_case(1, n_logits, n_labels)
    _, want = jfn(jax_outputs(outs), jax_targets(targets))
    _, got = tfn(torch_outputs(outs), torch_targets(targets))
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(1.0, abs(w)), (k, got[k], w)


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_gradients_match_jax(name):
    """d loss_total / d (logits, boxes) of every decoder output against
    ``jax.grad``: 1e-5 of each gradient's largest magnitude."""
    jfn, tfn, n_logits, n_labels = CRITERIA[name]
    outs, targets = make_case(2, n_logits, n_labels)
    jt = jax_targets(targets)

    def loss(flat):
        pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(outs))]
        return jfn(jax_outputs(pairs), jt)[0]

    want = jax.grad(loss)([jnp.asarray(a) for pair in outs for a in pair])
    out = torch_outputs(outs, requires_grad=True)
    total, _ = tfn(out, torch_targets(targets))
    total.backward()
    got = [t.grad for o in [out] + out["aux_outputs"]
           for t in (o["pred_logits"], o["pred_boxes"])]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# name: (JAX matcher, port matcher, logits width)
MATCHERS = {
    "detr": (jm.hungarian_match, tm.hungarian_match, 6),
    "focal": (jdc.focal_hungarian_match, tdc.focal_hungarian_match, 5),
}


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(MATCHERS))
def test_matcher_matches_jax(name, seed):
    """The same query for every valid target (the random costs have a
    unique optimum), -1 for padded targets in the port."""
    jfn, tfn, n_logits = MATCHERS[name]
    outs, targets = make_case(seed, n_logits, 5)
    want, _ = jfn(jax_outputs(outs[:1]), jax_targets(targets))
    got, valid = tfn(torch_outputs(outs[:1]), torch_targets(targets))
    want = np.asarray(want)
    assert got.dtype == torch.int64 and got.shape == (B, NT)
    np.testing.assert_array_equal(got.numpy()[targets["valid"]],
                                  want[targets["valid"]])
    assert (got.numpy()[~targets["valid"]] == -1).all()
    assert torch.equal(valid, torch.from_numpy(targets["valid"]))


def test_one_hungarian_call_per_criterion():
    """The final and auxiliary outputs are matched in one solver call."""
    outs, targets = make_case(5, 5, 5)
    calls = []

    def counting(cost, n_valid):
        calls.append(tuple(cost.shape))
        return hungarian_torch(cost, n_valid)

    with mock.patch.object(tm, "hungarian", counting):
        tdc.deformable_criterion(torch_outputs(outs), torch_targets(targets))
    assert calls == [((1 + N_AUX) * B, NQ, NT)]


def _frames(pkg, boxes_list, labels_list, absolute):
    """One ``pkg`` Frame per image of a batch, with boxes2d carrying Labels;
    absolute boxes are in pixels of a 40 x 60 frame."""
    out = []
    for boxes, labels in zip(boxes_list, labels_list):
        if pkg == "jax":
            from aloception_tpu import aloscene as A
            arr = lambda x: np.asarray(x, np.float32)
        else:
            from aloception_tpu_torch import aloscene as A
            arr = lambda x: torch.tensor(np.asarray(x, np.float32))
        f = A.Frame(arr(np.zeros((3, 40, 60))))
        f.append_boxes2d(A.BoundingBoxes2D(
            arr(boxes).reshape(-1, 4), boxes_format="xcyc", absolute=absolute,
            frame_size=(40, 60), labels=A.Labels(arr(labels))))
        out.append(f)
    return A.batch_list(out)


@pytest.mark.parametrize("absolute", [False, True])
def test_targets_from_frames_matches_jax(absolute):
    rng = np.random.RandomState(int(absolute))
    scale = np.array([60, 40, 60, 40], np.float32) if absolute else 1.0
    boxes = [rng.uniform(0.2, 0.5, (n, 4)).astype(np.float32) * scale
             for n in (3, 0, 5)]
    labels = [rng.randint(0, 4, len(b)).astype(np.float32) for b in boxes]
    want = jc.targets_from_frames(_frames("jax", boxes, labels, absolute),
                                  max_targets=4)
    got = tc.targets_from_frames(_frames("torch", boxes, labels, absolute),
                                 max_targets=4)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], atol=1e-6)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert got["labels"].dtype == torch.int64
