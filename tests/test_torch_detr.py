"""DETR of the PyTorch port against the JAX package on the CPU: the
uncentred sine embedding, ``EncoderLayer`` and ``DecoderLayer`` with a padded
key mask, the whole small model on a padded batch, ``inference`` and
``inference_arrays``, and the serving slice as a whole for both detectors:
Frame -> norm_resnet -> resize -> batch_list -> model -> inference.
Parameters are the JAX model's, moved by noise and loaded into the port
through ``utils/weights.py``; the JAX side runs at HIGHEST matmul precision.

Tolerances: 1e-5 for the embedding; 1e-4 for layers, model outputs, the
slice's resnet-normalised batch (its bilinear resize against the JAX
package's cv2 path) and the boxes and scores of the slice; 1e-6 for
``inference`` on shared logits; labels and the kept queries must be
equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu.models.detr import transformer as jtr
from aloception_tpu.models.transformers import (
    position_embedding_sine as jax_embedding)
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models import detr as tdetr
from aloception_tpu_torch.models.detr import transformer as ttr
from aloception_tpu_torch.models.transformers import position_embedding_sine
from aloception_tpu_torch.utils.weights import (
    deformable_state_dict_from_jax, detr_layer_state_dict_from_jax,
    detr_state_dict_from_jax)

from torch_parity import close, perturb, t, with_7x7_stem

D, NH, FF = 64, 4, 128
SMALL = dict(num_classes=10, hidden_dim=D, num_queries=20, nheads=NH,
             num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=FF,
             stage_sizes=(1, 1, 1, 1))
BACKGROUND = SMALL["num_classes"]
SIDE = 96      # the slice resizes each frame's longer side to this and pads


def key_padding(B, L):
    m = np.zeros((B, L), np.float32)
    m[1, -(L // 3):] = 1.0           # item 1: its last third is padding
    return m


def test_position_embedding_uncentred_matches_jax():
    mask = np.zeros((2, 7, 9), np.float32)
    mask[1, 5:, :] = 1.0
    mask[1, :, 6:] = 1.0
    want = jax_embedding(jnp.asarray(mask), num_pos_feats=D // 2)
    close(position_embedding_sine(t(mask), num_pos_feats=D // 2), want, 1e-5)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_matches_flax(kind):
    rng = np.random.RandomState(0)
    B, L, Nq = 2, 30, 7
    memory = rng.randn(B, L, D).astype(np.float32)
    pos = rng.randn(B, L, D).astype(np.float32)
    kpm = key_padding(B, L)
    if kind == "encoder":
        jl, tl = jtr.EncoderLayer(D, NH, FF), ttr.EncoderLayer(D, NH, FF)
        args = (memory, pos)
    else:
        jl, tl = jtr.DecoderLayer(D, NH, FF), ttr.DecoderLayer(D, NH, FF)
        args = (rng.randn(B, Nq, D).astype(np.float32), memory, pos,
                rng.randn(B, Nq, D).astype(np.float32))
    params = perturb(jl.init(jax.random.PRNGKey(0), *args, kpm)["params"],
                     rng)
    with jax.default_matmul_precision("highest"):
        want = jl.apply({"params": params}, *args, kpm)
    tl.load_state_dict(detr_layer_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tl(*map(t, args), key_padding_mask=t(kpm) >= 0.5)
    close(got, want, 1e-4)


@pytest.fixture(scope="module")
def detr_pair():
    """The small JAX DETR (space-to-depth stem) with perturbed params, and
    the port loaded with them."""
    rng = np.random.RandomState(0)
    jm = jdetr.Detr(**SMALL)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      np.zeros((1, 64, 64, 3), np.float32)
                                      )["params"], rng)
    with_7x7_stem(params["backbone"], rng)
    port = tdetr.Detr(**SMALL).eval()
    port.load_state_dict(detr_state_dict_from_jax(params), strict=True)
    return jm, params, port


def test_model_matches_flax(detr_pair):
    jm, params, port = detr_pair
    rng = np.random.RandomState(1)
    H, W = 64, 96
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[1, :, 64:] = 1.0
    mask[1, 40:, :] = 1.0
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jm.apply)({"params": params}, images,
                                                mask))
    with torch.no_grad():
        got = port(t(images), t(mask))
    for k in ("pred_logits", "pred_boxes"):
        close(got[k], want[k], 1e-4)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 1
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        close(ga["pred_logits"], wa["pred_logits"], 1e-4)
        close(ga["pred_boxes"], wa["pred_boxes"], 1e-4)


def fake_outputs(seed):
    rng = np.random.RandomState(seed)
    return {"pred_logits": (2 * rng.randn(3, 20, BACKGROUND + 1)).astype(
                np.float32),
            "pred_boxes": rng.uniform(0, 1, (3, 20, 4)).astype(np.float32)}


def same_detections(got, want, atol):
    """Port detections against the JAX ones: per image, the same kept
    queries with their boxes, labels and scores."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tsc.BoundingBoxes2D)
        assert (g.boxes_format, g.absolute) == ("xcyc", False)
        labels = g.get_child("labels")
        assert isinstance(labels, tsc.Labels)
        assert labels.dtype == torch.float32
        close(g.array, w.as_numpy(), atol)
        assert np.array_equal(labels.array.numpy(),
                              w.get_child("labels").as_numpy())
        close(labels.scores, w.get_child("labels").scores, atol)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_inference_matches_jax(threshold):
    out = fake_outputs(int(threshold * 10))
    want = jdetr.inference(out, threshold=threshold,
                           background_class=BACKGROUND)
    got = tdetr.inference({k: t(v) for k, v in out.items()},
                          threshold=threshold, background_class=BACKGROUND)
    same_detections(got, want, 1e-6)
    assert 0 < sum(len(g) for g in got) < 60


def test_inference_arrays_matches_jax():
    out = fake_outputs(2)
    want = jdetr.inference_arrays(out, background_class=BACKGROUND)
    got = tdetr.inference_arrays({k: t(v) for k, v in out.items()},
                                 background_class=BACKGROUND)
    close(got[0], want[0], 0.0)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2], 1e-6)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))


# ----------------------------------------------------------------------
# the serving slice, through Frames, in both packages
# ----------------------------------------------------------------------
def frame_batch(pkg, images):
    """Frame -> norm_resnet -> resize (longer side SIDE, aspect kept) ->
    batch_list(size=(SIDE, SIDE))."""
    frames = []
    for x in images:
        f = pkg.Frame(x).norm_resnet()
        scale = SIDE / max(f.HW)
        frames.append(f.resize((round(f.H * scale), round(f.W * scale))))
    return pkg.batch_list(frames, size=(SIDE, SIDE))


def deformable_pair():
    rng = np.random.RandomState(3)
    jm = jdd.DeformableDETR(**SMALL)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      np.zeros((1, 64, 64, 3), np.float32)
                                      )["params"], rng)
    with_7x7_stem(params["backbone"], rng)
    port = tdd.DeformableDETR(**SMALL).eval()
    port.load_state_dict(deformable_state_dict_from_jax(params, False),
                         strict=True)
    return jm, params, port


@pytest.mark.parametrize("detector", ["detr", "deformable"])
def test_frame_slice_matches_jax(detector, detr_pair):
    rng = np.random.RandomState(4)
    # one frame shrinks, one grows, by non-integer ratios
    images = [rng.uniform(0, 255, (3,) + hw).astype(np.float32)
              for hw in ((120, 150), (60, 50))]
    jb = frame_batch(jsc, images)
    tb = frame_batch(tsc, [torch.from_numpy(x) for x in images])
    # the two bilinear resizes differ in the last bits of their weights
    close(tb.array, jb.as_numpy(), 1e-4)
    assert np.array_equal(tb.mask.as_numpy(), jb.mask.as_numpy())
    assert float(tb.mask.array.sum()) > 0

    if detector == "detr":
        jm, params, port = detr_pair
    else:
        jm, params, port = deformable_pair()
    layout = ("B", "H", "W", "C")
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jm.apply)(
            {"params": params}, jb.as_layout(layout),
            jb.mask.as_numpy()[:, 0]))
    with torch.no_grad():
        got = port(tb.as_layout(layout), tb.mask.array[:, 0])
    for k in ("pred_logits", "pred_boxes"):
        close(got[k], want[k], 1e-4)

    if detector == "detr":
        probs = jax.nn.softmax(want["pred_logits"], -1)
        top2 = np.sort(np.asarray(probs), -1)[..., -2:]
        # no query is within reach of a tie between background and a class
        assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
        want_dets = jdetr.inference(want, background_class=BACKGROUND)
        got_dets = tdetr.inference(got, background_class=BACKGROUND)
    else:
        scores = 1 / (1 + np.exp(-np.asarray(want["pred_logits"])))
        # no score is within reach of the default threshold
        assert np.abs(scores.max(-1) - 0.2).min() > 1e-3
        want_dets = jdd.inference(want)
        got_dets = tdd.inference(got)
    same_detections(got_dets, want_dets, 1e-4)
    assert sum(len(g) for g in got_dets) > 0


@pytest.mark.parametrize("factory", ["detr_r50", "deformable_detr_r50"])
def test_factory_builds_on_the_card_or_raises(factory):
    """With no device the factories build on the CUDA card; without a card
    they raise and point at device="cpu", which builds on the CPU."""
    build = getattr(tdetr if factory == "detr_r50" else tdd, factory)
    small = {k: v for k, v in SMALL.items() if k != "num_classes"}
    if torch.cuda.is_available():
        assert next(build(**small).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(**small)
    model = build(device="cpu", **small)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
