"""``deformable_state_dict_from_jax``, ``detr_state_dict_from_jax`` and
``panoptic_state_dict_from_jax`` are the exact inverses of the JAX package's
torch -> flax converters: JAX params -> port state_dict ->
``convert_deformable_checkpoint`` / ``convert_detr_checkpoint`` /
``convert_panoptic_checkpoint`` gives back the same params, bit for bit, and
the state_dict loads strictly into the port's model. Full ResNet-50 stages (the
converters'), a narrow transformer; params drawn with numpy over the JAX
model's shapes."""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aloception_tpu.models.backbone.resnet import conv1_to_s2d_kernel
from aloception_tpu.models.deformable_detr import DeformableDETR as JaxDETR
from aloception_tpu.models.detr import Detr as JaxDetr
from aloception_tpu.models.panoptic import DetrPanoptic as JaxPanoptic
from aloception_tpu.utils import weights as jax_weights
from aloception_tpu.utils.weights import (convert_deformable_checkpoint,
                                          convert_detr_checkpoint)
from aloception_tpu_torch.models.deformable_detr import DeformableDETR
from aloception_tpu_torch.models.detr import Detr
from aloception_tpu_torch.models.panoptic import DetrPanoptic
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax,
                                                panoptic_state_dict_from_jax,
                                                s2d_stem_to_7x7)

SMALL = dict(num_classes=10, hidden_dim=64, num_queries=20, nheads=4,
             num_encoder_layers=2, num_decoder_layers=3, dim_feedforward=128)


def _random_params(model, space_to_depth, rng, backbone=("backbone",)):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    if space_to_depth:   # only kernels that came from a 7x7 have a 7x7 form
        w7 = rng.randn(7, 7, 3, 64).astype(np.float32)
        tree = params
        for key in backbone:
            tree = tree[key]
        tree["trunk"]["conv1"]["kernel"] = np.asarray(conv1_to_s2d_kernel(w7))
    return params


@pytest.mark.parametrize("space_to_depth", [True, False])
@pytest.mark.parametrize("with_box_refine", [True, False])
def test_round_trip_through_jax_converter_is_exact(with_box_refine,
                                                   space_to_depth):
    rng = np.random.RandomState(0)
    params = _random_params(JaxDETR(with_box_refine=with_box_refine,
                                    space_to_depth=space_to_depth, **SMALL),
                            space_to_depth, rng)
    sd = deformable_state_dict_from_jax({"params": params}, with_box_refine)

    back = convert_deformable_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, d_model=64, nheads=4,
        num_enc=2, num_dec=3, with_box_refine=with_box_refine,
        space_to_depth=space_to_depth)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), \
            jax.tree_util.keystr(k)

    port = DeformableDETR(with_box_refine=with_box_refine, **SMALL)
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)


@pytest.mark.parametrize("space_to_depth", [True, False])
def test_detr_round_trip_through_jax_converter_is_exact(space_to_depth):
    rng = np.random.RandomState(1)
    params = _random_params(JaxDetr(space_to_depth=space_to_depth, **SMALL),
                            space_to_depth, rng)
    sd = detr_state_dict_from_jax({"params": params})

    back = convert_detr_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, d_model=64, nheads=4,
        num_enc=2, num_dec=3, space_to_depth=space_to_depth)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), \
            jax.tree_util.keystr(k)

    port = Detr(**SMALL)
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)


@pytest.mark.parametrize("space_to_depth", [True, False])
@pytest.mark.parametrize("detector", ["detr", "deformable"])
def test_panoptic_round_trip_through_jax_converter_is_exact(
        detector, space_to_depth, monkeypatch):
    """The panoptic head's reference names and the wrapped detector's under
    ``detr.``. ``convert_panoptic_checkpoint`` converts its detector with
    ``convert_detr_checkpoint`` at full width; here it is given the narrow
    transformer's widths, and for Deformable-DETR, which the reference
    publishes no panoptic checkpoint of, the Deformable converter."""
    rng = np.random.RandomState(3)
    dims = dict(d_model=64, nheads=4, num_enc=2, num_dec=3)
    kw = dict(return_intermediate=True, **SMALL)
    if detector == "detr":
        jax_det, port_det = JaxDetr(space_to_depth=space_to_depth, **kw), \
            Detr(**kw)
        convert = partial(convert_detr_checkpoint, **dims)
    else:
        jax_det = JaxDETR(space_to_depth=space_to_depth, **kw)
        port_det = DeformableDETR(**kw)
        convert = partial(convert_deformable_checkpoint, **dims)
    monkeypatch.setattr(jax_weights, "convert_detr_checkpoint", convert)
    params = _random_params(JaxPanoptic(detector=jax_det, num_classes=10),
                            space_to_depth, rng, ("detector", "backbone"))
    sd = panoptic_state_dict_from_jax({"params": params})

    back = jax_weights.convert_panoptic_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, space_to_depth=space_to_depth)
    back = {"detector": back["detr"]["params"],
            "panoptic_head": back["head"]["params"]}
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), \
            jax.tree_util.keystr(k)

    port = DetrPanoptic(port_det, num_classes=10)
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)
    assert {k.split(".")[0] for k in sd} == {"detr", "bbox_attention",
                                             "mask_head"}


def test_s2d_stem_outside_7x7_window_is_refused():
    w4 = np.array(conv1_to_s2d_kernel(np.ones((7, 7, 3, 8), np.float32)))
    assert np.array_equal(s2d_stem_to_7x7(w4), np.ones((7, 7, 3, 8)))
    w4[0, 0, 0, 0] = 1.0          # w8[0, 0]: no 7x7 tap lands there
    with pytest.raises(ValueError):
        s2d_stem_to_7x7(w4)


@pytest.mark.parametrize("with_box_refine", [True, False, None],
                         ids=["deformable_refine", "deformable", "detr"])
def test_converters_map_gradient_trees(with_box_refine):
    """A JAX gradient tree has the params' structure, and the converters only
    reshape, transpose and concatenate, which are linear: the converted tree
    of x + 2y is, bit for bit, convert(x) + 2 convert(y), and it names every
    parameter of the port with its shape (the train-step parity test maps
    JAX gradients this way). Plain 7x7 stems: a space-to-depth stem's
    gradient has taps outside the 7x7 window."""
    rng = np.random.RandomState(2)
    if with_box_refine is None:
        jax_model = JaxDetr(space_to_depth=False, **SMALL)
        convert, port = detr_state_dict_from_jax, Detr(**SMALL)
    else:
        jax_model = JaxDETR(with_box_refine=with_box_refine,
                            space_to_depth=False, **SMALL)
        port = DeformableDETR(with_box_refine=with_box_refine, **SMALL)

        def convert(p):
            return deformable_state_dict_from_jax(p, with_box_refine)
    x = _random_params(jax_model, False, rng)
    y = _random_params(jax_model, False, rng)
    mixed = jax.tree_util.tree_map(lambda a, b: a + 2 * b, x, y)
    cx, cy, cm = convert(x), convert(y), convert(mixed)
    for name, p in port.named_parameters():
        assert cm[name].shape == p.shape, name
        assert np.array_equal(cm[name].numpy(),
                              (cx[name] + 2 * cy[name]).numpy()), name
