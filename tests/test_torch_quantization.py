"""Quantization of the PyTorch port's export subsystem against the JAX
package on the CPU: weights-only int8 (values equal and scales within one
ulp once the converters map the flax layouts to the port's, with the
tensors JAX leaves alone left alone), QAT's fake quantisation in the JAX
package's groups, the four calibrators on the same numpy data, and the
``DataBatchStreamer`` over the COCO sample.

The flax layouts come from the ``*_state_dict_from_jax`` converters, which
only transpose, reshape and concatenate: a tree of the JAX parameters'
structure holding a mask, the int8 values or the scales converts to the
port's names and layouts.
"""

import copy

import numpy as np
import pytest
import torch

from aloception_tpu import export as jexport
from aloception_tpu.models.deformable_detr import DeformableDETR as JaxDeformable
from aloception_tpu.models.detr import Detr as JaxDetr
from aloception_tpu_torch import export as texport
from aloception_tpu_torch.models.deformable_detr import DeformableDETR
from aloception_tpu_torch.models.detr import Detr
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax)

from torch_parity import init_like, perturb, t, with_7x7_stem

TINY = dict(hidden_dim=64, num_queries=16, nheads=4, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=64, stage_sizes=(1, 1, 1, 1))
HW = (64, 96)
MIN_SIZE = 256


@pytest.fixture(scope="module")
def deformable_pair():
    """Tiny Deformable-DETR + refine: Linear, Conv2d, MultiheadAttention
    (decoder self-attention) and Embedding weights."""
    rng = np.random.RandomState(11)
    jm = JaxDeformable(num_classes=4, with_box_refine=True, **TINY)
    x = np.zeros((1,) + HW + (3,), np.float32)
    m = np.zeros((1,) + HW, np.float32)
    v = {"params": perturb(init_like(jm, rng, x, m)["params"], rng)}
    with_7x7_stem(v["params"]["backbone"], rng)
    port = DeformableDETR(num_classes=4, with_box_refine=True, device="cpu",
                          **TINY).eval()
    port.load_state_dict(deformable_state_dict_from_jax(v, True), strict=True)
    return v, port


def _convert(tree):
    return deformable_state_dict_from_jax(tree, True)


def _split(params, quantized):
    """Trees of the params' structure from JAX's int8 output: 1 where a
    kernel was quantized, its int8 values, its scales broadcast to the
    kernel; zeros elsewhere."""
    if isinstance(quantized, dict) and set(quantized) == {"q", "scale"}:
        q = np.asarray(quantized["q"], np.float32)
        scale = np.broadcast_to(np.asarray(quantized["scale"]), q.shape)
        return np.ones_like(q), q, np.array(scale)
    if isinstance(params, dict):
        parts = {k: _split(params[k], quantized[k]) for k in params}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(3))
    zero = np.zeros(np.shape(params), np.float32)
    return zero, zero, zero


def test_int8_matches_jax(deformable_pair):
    v, port = deformable_pair
    jq, jdequant = jexport.quantize_weights_int8(v, min_size=MIN_SIZE)
    mask, q, scale = (_convert(tree) for tree in _split(v, jq))
    got, dequant = texport.quantize_weights_int8(port, min_size=MIN_SIZE)
    state = port.state_dict()
    assert set(got) == set(mask) == set(state)
    quantized = {k for k, x in got.items() if isinstance(x, dict)}
    # the int8 set: Linear weights; not the attention's packed in_proj or
    # out_proj (3-d DenseGeneral kernels in flax), embeddings, convs
    assert quantized and all(k.endswith(".weight") for k in quantized)
    assert not any("self_attn.in_proj" in k or "self_attn.out_proj" in k
                   or "query_embed" in k for k in quantized)
    for name, x in got.items():
        if name in quantized:
            assert bool(mask[name].eq(1).all()), name
            assert x["q"].dtype == torch.int8
            assert torch.equal(x["q"].float(), q[name]), name
            want = scale[name][:, :1]
            ulp = np.spacing(want.numpy())
            assert np.all(np.abs(x["scale"].numpy() - want.numpy()) <= ulp)
        else:
            assert bool(mask[name].eq(0).all()), name
            assert x is state[name] or torch.equal(x, state[name])
    err = texport.quantization_error(port, got, dequant)
    want_err = jexport.quantization_error(v, jq, jdequant)
    assert abs(err - want_err) <= 1e-6 and 0 < err < 0.02


def test_qat_groups_match_jax(deformable_pair):
    """Every kernel JAX fake-quantises, in its groups: per output channel
    for Dense, Conv and the attention output; per head_dim index across
    heads for the packed query/key/value projection."""
    v, port = deformable_pair
    want = _convert(jexport.quantize_params_for_qat(v, min_size=MIN_SIZE))
    got = texport.quantize_params_for_qat(port, min_size=MIN_SIZE)
    assert set(got) <= set(want)
    changed = 0
    for name, x in got.items():
        ref = want[name]
        err = (x.detach() - ref).abs().max().item()
        assert err <= 1e-6 * max(1.0, ref.abs().max().item()), (name, err)
        changed += not torch.equal(x.detach(), dict(port.named_parameters())[
            name].detach())
    assert changed > 0
    in_proj = [k for k in got if k.endswith("self_attn.in_proj_weight")]
    assert in_proj and all(not torch.equal(
        got[k].detach(), texport.fake_quant(
            dict(port.named_parameters())[k].detach(), axis=1))
        for k in in_proj)


def test_fake_quant_is_straight_through():
    rng = np.random.RandomState(0)
    x = t(rng.randn(6, 5, 4)).requires_grad_(True)
    cot = t(rng.randn(6, 5, 4))
    y = texport.fake_quant(x, bits=4, axis=(0, 1))
    want = np.asarray(jexport.fake_quant(x.detach().numpy(), bits=4,
                                         axis=(0, 1)))
    assert np.abs(y.detach().numpy() - want).max() <= 1e-6
    (y * cot).sum().backward()
    assert torch.equal(x.grad, cot)


def test_qat_finetune_int8_within_tolerance():
    """The JAX test's contract on the port: a few fake-quant finetune steps
    through ``functional_call``, then the int8 weights-only model stays
    within 5 % of the float32 model's logits on the sanity batch."""
    rng = np.random.RandomState(0)
    jm = JaxDetr(num_classes=4, **TINY)
    x = np.zeros((1,) + HW + (3,), np.float32)
    v = {"params": init_like(jm, rng, x, np.zeros((1,) + HW, np.float32))[
        "params"]}
    with_7x7_stem(v["params"]["backbone"], rng)
    model = Detr(num_classes=4, device="cpu", **TINY).eval()
    model.load_state_dict(detr_state_dict_from_jax(v), strict=True)
    images = t(rng.randn(2, *HW, 3))
    mask = torch.zeros(2, *HW)
    with torch.no_grad():
        target = model(images, mask)["pred_logits"]
    opt = torch.optim.SGD(model.parameters(), lr=1e-5)
    for _ in range(3):
        params = texport.quantize_params_for_qat(model, min_size=MIN_SIZE)
        out = torch.func.functional_call(model, params, (images, mask))
        loss = (out["pred_logits"] - target).pow(2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert np.isfinite(loss.item())
    q, dequant = texport.quantize_weights_int8(model, min_size=MIN_SIZE)
    int8 = copy.deepcopy(model)
    int8.load_state_dict(dequant(q))
    with torch.no_grad():
        out_f32 = model(images, mask)["pred_logits"]
        out_int8 = int8(images, mask)["pred_logits"]
    rel = ((out_int8 - out_f32).abs().max() / out_f32.abs().max()).item()
    assert rel < 0.05, rel


def _calibration_data():
    """The JAX test's data: N(0, 1) with two extreme outliers."""
    rng = np.random.RandomState(0)
    body = rng.randn(100_000).astype(np.float32)
    return np.concatenate([body, np.array([120.0, -150.0], np.float32)])


@pytest.mark.parametrize("name", ["MinMaxCalibrator", "PercentileCalibrator",
                                  "EntropyCalibrator"])
def test_calibrators_match_jax(name):
    """The same observations (two halves: the range grows) give the same
    histograms and scales as the JAX package's calibrators."""
    data = _calibration_data()
    scales = []
    for pkg in (jexport, texport):
        calib = getattr(pkg, name)()
        for part in (data[:50_000], data[50_000:], -data[:10]):
            calib.observe("a", part)
        calib.observe("b", data[:1000] * 3)
        scales.append((calib.scales(), calib.scales(bits=4),
                       getattr(calib, "hists", None)))
    (want, want4, jh), (got, got4, th) = scales
    assert got == want and got4 == want4
    if jh is not None:
        assert set(th) == set(jh)
        for k in jh:
            assert np.array_equal(th[k], jh[k])


def test_percentile_clips_the_tail():
    data = _calibration_data()
    pc = texport.PercentileCalibrator(percentile=99.9)
    pc.observe("a", t(data[:50_000]))        # tensors are observed too
    pc.observe("a", data[50_000:])
    s_pct = pc.scales()["a"]
    assert 1.0 / 127 < s_pct < 10.0 / 127
    mm = texport.MinMaxCalibrator()
    mm.observe("a", t(data))
    assert mm.scales()["a"] == pytest.approx(150.0 / 127)


def test_streamer_over_coco_sample_matches_jax():
    """``DataBatchStreamer`` calls the port's ``train_loader(batch_size=,
    shuffle=False)`` (no ``num_workers``): the same frames in the same order
    as the JAX streamer, and a min-max calibration over them agrees."""
    from aloception_tpu.alodataset import CocoBaseDataset as JaxCoco
    from aloception_tpu_torch.alodataset import CocoBaseDataset

    batches = []
    for ds, pkg in ((JaxCoco(sample=True), jexport),
                    (CocoBaseDataset(sample=True), texport)):
        streamer = pkg.DataBatchStreamer(ds, batch_size=2, max_batches=2)
        frames = [[np.asarray(f.as_numpy()) for f in b] for b in streamer]
        calib = pkg.MinMaxCalibrator()
        scales = calib.calibrate(
            lambda b: {"input": np.concatenate([np.asarray(
                f.as_numpy()).ravel() for f in b])}, streamer)
        batches.append((frames, scales))
    (jframes, jscales), (tframes, tscales) = batches
    assert len(tframes) == len(jframes) == 2
    for tb, jb in zip(tframes, jframes):
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-4
    assert tscales["input"] == pytest.approx(jscales["input"], rel=1e-6)
