"""Deformable-DETR's softmax head in the PyTorch port against the JAX
package on the CPU: ``DeformableDETR(activation_fn="softmax")`` (its
``num_classes + 1`` logits, its background class) on the JAX model's
parameters, converted by ``deformable_state_dict_from_jax``, down to
``inference(..., activation_fn="softmax")``; and the activation that
``make_panoptic_trainer`` takes from its detector. Tolerances as the
sigmoid model's (``test_torch_deformable.py``): 1e-4."""

import numpy as np
import pytest
import torch

import jax

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models import detr as tdetr
from aloception_tpu_torch.models.panoptic import inference_with_masks
from aloception_tpu_torch.train import CocoDetection2Detr, make_panoptic_trainer
from aloception_tpu_torch.train import experiment
from aloception_tpu_torch.utils.weights import deformable_state_dict_from_jax

from test_torch_deformable import TINY
from torch_parity import close, perturb, t, with_7x7_stem


@pytest.mark.parametrize("with_box_refine", [True, False])
def test_softmax_model_matches_flax(with_box_refine):
    rng = np.random.RandomState(3 + with_box_refine)
    H, W = 64, 96
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[1, :, 64:] = 1.0

    jm = jdd.DeformableDETR(with_box_refine=with_box_refine,
                            activation_fn="softmax", **TINY)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), images[:1],
                                      mask[:1])["params"], rng)
    with_7x7_stem(params["backbone"], rng)
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jm.apply)({"params": params}, images,
                                                mask))
    port = tdd.DeformableDETR(with_box_refine=with_box_refine,
                              activation_fn="softmax", **TINY).eval()
    assert port.background_class == jm.background_class == TINY["num_classes"]
    port.load_state_dict(deformable_state_dict_from_jax(params,
                                                        with_box_refine),
                         strict=True)
    with torch.no_grad():
        got = port(t(images), t(mask))
    assert got["pred_logits"].shape[-1] == TINY["num_classes"] + 1
    close(got["pred_logits"], want["pred_logits"], 1e-4)
    close(got["pred_boxes"], want["pred_boxes"], 1e-4)
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        close(ga["pred_logits"], wa["pred_logits"], 1e-4)
        close(ga["pred_boxes"], wa["pred_boxes"], 1e-4)

    # a threshold in the widest gap between the kept queries' scores
    probs = np.exp(want["pred_logits"] - want["pred_logits"].max(-1,
                                                                  keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    kept = probs.argmax(-1) != TINY["num_classes"]
    scores = np.sort(probs.max(-1)[kept])
    gap = np.argmax(np.diff(scores)) if len(scores) > 1 else -1
    threshold = float(scores[gap] + scores[gap + 1]) / 2 if gap >= 0 else 0.0
    want_inf = jdd.inference(want, threshold=threshold,
                             activation_fn="softmax")
    got_inf = tdd.inference(got, threshold=threshold,
                            activation_fn="softmax")
    assert sum(len(g) for g in got_inf) == sum(len(w) for w in want_inf) > 0
    for g, w in zip(got_inf, want_inf):
        labels = w.get_child("labels")
        close(g.array, w.as_numpy(), 1e-4)
        assert np.array_equal(g.labels.array.numpy(), labels.as_numpy())
        close(g.labels.scores, labels.scores, 1e-4)


def test_activation_fn_is_checked():
    with pytest.raises(ValueError, match="activation_fn"):
        tdd.DeformableDETR(activation_fn="relu", **TINY)
    assert tdd.DeformableDETR(**TINY).background_class is None


@pytest.mark.parametrize("detector", ["detr", "deformable_sigmoid",
                                      "deformable_softmax"])
def test_panoptic_trainer_takes_the_detectors_activation(detector, tmp_path,
                                                         monkeypatch):
    """``make_panoptic_trainer`` reads ``activation_fn`` from its detector
    (DETR's is softmax), as the JAX factory does, not the detector's type:
    the background class is the detector's ``num_classes`` where it is
    softmax, and None where it is sigmoid."""
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))
    dm = CocoDetection2Detr(sample=True, return_masks=True, size=(64, 96))
    n_cls = len(dm.label_names)
    kw = dict(TINY, num_classes=n_cls, return_intermediate=True, device="cpu")
    det = (tdetr.Detr(**kw) if detector == "detr" else tdd.DeformableDETR(
        activation_fn=detector.split("_")[1], **kw))
    trainer = make_panoptic_trainer(data_module=dm, detector=det,
                                    log_dir=str(tmp_path), device="cpu")
    fn = trainer.inference_fn
    assert fn.func is inference_with_masks
    act = "sigmoid" if detector == "deformable_sigmoid" else "softmax"
    assert fn.keywords["activation_fn"] == act
    assert fn.keywords["background_class"] == (n_cls if act == "softmax"
                                               else None)
