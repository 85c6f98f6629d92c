"""Deformable-DETR of the PyTorch port against the JAX package on the CPU:
``MSDeformAttn`` (2-d and 4-d reference points), the transformer, and the
whole tiny model with and without box refinement, on images with a padded
region, down to ``inference``. Parameters are the JAX model's, moved by
noise and loaded into the port through ``deformable_state_dict_from_jax``;
the JAX side runs its Pallas MSDA kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models.deformable_detr.deformable_transformer import (
    DeformableTransformer as JaxTransformer)
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models.deformable_detr.deformable_transformer import (
    DeformableTransformer)
from aloception_tpu_torch.utils.weights import (
    deformable_state_dict_from_jax, msdeform_attn_state_dict_from_jax,
    transformer_state_dict_from_jax)

from torch_parity import close, perturb, t

D, NH, L, P = 64, 4, 4, 4
SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
LV = sum(h * w for h, w in SHAPES)
TINY = dict(num_classes=10, hidden_dim=D, num_queries=20, nheads=NH,
            num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
            stage_sizes=(1, 1, 1, 1))


def _level_masks(rng, B):
    masks = []
    for h, w in SHAPES:
        m = np.zeros((B, h, w), np.float32)
        m[1, :, max(1, w - w // 3):] = 1.0     # image 1 padded on the right
        masks.append(m)
    return masks


@pytest.mark.parametrize("level", range(len(SHAPES)))
def test_position_embedding_matches_jax(level):
    """The port's centred sine embedding (Deformable-DETR's) is the JAX
    function's."""
    from aloception_tpu.models.transformers import position_embedding_sine
    from aloception_tpu_torch.models.transformers import (
        position_embedding_sine as port_embedding)
    mask = _level_masks(np.random.RandomState(level), 2)[level]
    want = position_embedding_sine(jnp.asarray(mask), num_pos_feats=D // 2,
                                   center=True)
    close(port_embedding(t(mask), num_pos_feats=D // 2, center=True), want,
          1e-5)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn_matches_flax(ref_dim):
    rng = np.random.RandomState(ref_dim)
    B, Lq = 2, 37
    query = rng.randn(B, Lq, D).astype(np.float32)
    src = rng.randn(B, LV, D).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (B, Lq, L, ref_dim)).astype(np.float32)
    pad = np.concatenate([m.reshape(B, -1) for m in _level_masks(rng, B)], 1)

    jm = jdd.MSDeformAttn(D, L, NH, P)
    init = jax.jit(lambda *a: jm.init(*a[:4], SHAPES, a[4]))
    params = perturb(init(jax.random.PRNGKey(0), query, ref, src,
                          pad)["params"], rng)
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, query, ref, src, SHAPES, pad)

    port = tdd.MSDeformAttn(D, L, NH, P)
    port.load_state_dict(msdeform_attn_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(t(query), t(ref), t(src), SHAPES, t(pad))
    close(got, want, 1e-4)


def test_transformer_matches_flax():
    rng = np.random.RandomState(0)
    B = 2
    srcs = [rng.randn(B, h, w, D).astype(np.float32) for h, w in SHAPES]
    pos = [rng.randn(B, h, w, D).astype(np.float32) for h, w in SHAPES]
    masks = _level_masks(rng, B)
    query_embed = rng.randn(20, 2 * D).astype(np.float32)

    jt = JaxTransformer(d_model=D, n_heads=NH, num_encoder_layers=2,
                        num_decoder_layers=2, dim_feedforward=128,
                        n_levels=L, n_points=P)
    params = perturb(jax.jit(jt.init)(jax.random.PRNGKey(0), srcs, masks, pos,
                                      query_embed)["params"], rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jt.apply)({"params": params}, srcs, masks, pos,
                                 query_embed)

    port = DeformableTransformer(D, NH, 2, 2, 128, L, P)
    port.load_state_dict(transformer_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port([t(s) for s in srcs], [t(m) for m in masks],
                   [t(p) for p in pos], t(query_embed))
    for i in (0, 1, 2, 3, 5):   # hs, init_ref, inter_refs, memory, ratios
        close(got[i], want[i], 1e-4)
    assert got[4] == want[4]


@pytest.mark.parametrize("with_box_refine", [True, False])
def test_model_matches_flax(with_box_refine):
    rng = np.random.RandomState(int(with_box_refine))
    H, W = 64, 96
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[1, :, 64:] = 1.0
    mask[1, 48:, :] = 1.0

    jm = jdd.DeformableDETR(with_box_refine=with_box_refine, **TINY)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), images[:1],
                                      mask[:1])["params"], rng)
    # the JAX model's default space-to-depth stem, from a 7x7 kernel
    from aloception_tpu.models.backbone.resnet import conv1_to_s2d_kernel
    w7 = (rng.randn(7, 7, 3, 64) / np.sqrt(147)).astype(np.float32)
    params["backbone"]["trunk"]["conv1"]["kernel"] = np.asarray(
        conv1_to_s2d_kernel(w7))
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jm.apply)({"params": params}, images,
                                                mask))

    port = tdd.DeformableDETR(with_box_refine=with_box_refine, **TINY).eval()
    port.load_state_dict(deformable_state_dict_from_jax(params,
                                                        with_box_refine),
                         strict=True)
    with torch.no_grad():
        got = port(t(images), t(mask))

    close(got["pred_logits"], want["pred_logits"], 1e-4)
    close(got["pred_boxes"], want["pred_boxes"], 1e-4)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 1
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        close(ga["pred_logits"], wa["pred_logits"], 1e-4)
        close(ga["pred_boxes"], wa["pred_boxes"], 1e-4)

    # a threshold in the widest gap between the scores: both keep one set
    scores = np.sort((1 / (1 + np.exp(-want["pred_logits"]))).max(-1).ravel())
    gap = np.argmax(np.diff(scores))
    threshold = float(scores[gap] + scores[gap + 1]) / 2
    want_inf = jdd.inference(want, threshold=threshold)
    got_inf = tdd.inference(got, threshold=threshold)
    assert sum(len(g) for g in got_inf) == len(scores) - gap - 1
    for g, w in zip(got_inf, want_inf):
        labels = w.get_child("labels")
        assert (g.boxes_format, g.absolute) == ("xcyc", False)
        close(g.array, w.as_numpy(), 1e-4)
        assert np.array_equal(g.labels.array.numpy(), labels.as_numpy())
        close(g.labels.scores, labels.scores, 1e-4)
