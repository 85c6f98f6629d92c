"""RAFT inference of the PyTorch port against the JAX package on the CPU.

Cases: both encoders with each norm; both update blocks, the mask head on
and off; ``upflow8``, ``convex_upsample`` and ``Padder`` in both modes; the
whole model (the bench's tiny RAFT at 64x64 and 64x96, the standard widths
and RAFT-small at 64x96) on both paths and with ``flow_init``; ``only_last``
against the last flow of the list; ``inference``; the serving slice as a
whole (uint8 frames -> Frame -> norm_minmax_sym -> batch -> Padder -> RAFT
-> unpad -> inference); ``Flow`` geometry and the Sintel sample against the
JAX objects; ``eval_on_sintel``; the factories' device rule; the weights'
round trip through ``convert_raft_checkpoint``.

The port is NCHW, the JAX package NHWC. Variables are drawn as flax's init
draws them (``init_like``), moved by noise (``perturb``: BatchNorm running
statistics non-trivial) and loaded into the port through
``utils/weights.py``; the JAX side runs at HIGHEST matmul precision.
Tolerances, each times max(1, max|ref|): 1e-5 for the upsampling, 1e-4 for
the blocks and the whole model (float32 convolutions summed in another
order, then 2 recurrent steps); only_last against the list 1e-5; Padder
exact; bfloat16 against the JAX bfloat16 model 3e-2; ``Flow.resize`` 1e-5
(torch's bilinear weights against cv2's differ in the last bits, as in
``test_torch_aloscene.py``), the other Flow ops one ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu.alodataset.sintel import SintelFlowDataset as JSintel
from aloception_tpu.models.raft import extractor as jext
from aloception_tpu.models.raft import raft as jraft
from aloception_tpu.models.raft import update as jup
from aloception_tpu.models.raft.utils import Padder as JPadder
from aloception_tpu.utils.weights import convert_raft_checkpoint
from aloception_tpu_torch.alodataset import SintelFlowDataset
from aloception_tpu_torch.commands import eval_on_sintel
from aloception_tpu_torch.models import raft as traft
from aloception_tpu_torch.models.raft import extractor as text
from aloception_tpu_torch.models.raft import update as tup
from aloception_tpu_torch.utils.weights import (
    raft_encoder_state_dict_from_jax, raft_state_dict_from_jax,
    raft_update_state_dict_from_jax)

from test_torch_aloscene import same
from torch_parity import close, init_like, perturb, t


def nchw(x) -> torch.Tensor:
    return t(np.moveaxis(np.asarray(x), -1, 1))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().float().numpy(), 1, -1)


def check(got: torch.Tensor, want, rel: float, tag: str):
    """got (NCHW) against want (NHWC) within rel * max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(nhwc(got) - want).max())
    print(f"{tag}: max|diff| {err:.3e} (tol {tol:.3e})")
    assert err <= tol, (tag, err, tol)


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["instance", "batch", "group", "none"])
@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_encoder_matches_flax(small, norm):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jm = (jext.SmallEncoder if small else jext.BasicEncoder)(
        output_dim=64, norm_fn=norm)
    v = perturb(init_like(jm, rng, x), rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    port = (text.SmallEncoder if small else text.BasicEncoder)(64, norm).eval()
    port.load_state_dict(raft_encoder_state_dict_from_jax(
        v["params"], v.get("batch_stats", {}), small=small), strict=True)
    with torch.no_grad():
        got = port(nchw(x))
    check(got, want, 1e-4, f"{'small' if small else 'basic'} encoder {norm}")


@pytest.mark.parametrize("block", ["basic_mask", "basic_no_mask", "small"])
def test_update_block_matches_flax(block):
    rng = np.random.RandomState(1)
    small = block == "small"
    hidden, context = (96, 64) if small else (32, 32)
    corr_ch = 2 * 5 ** 2
    B, H, W = 2, 8, 12
    net = rng.uniform(-1, 1, (B, H, W, hidden)).astype(np.float32)
    inp = rng.uniform(0, 1, (B, H, W, context)).astype(np.float32)
    corr = rng.randn(B, H, W, corr_ch).astype(np.float32)
    flow = rng.uniform(-4, 4, (B, H, W, 2)).astype(np.float32)
    jm = (jup.SmallUpdateBlock if small else jup.BasicUpdateBlock)(
        corr_channels=corr_ch, hidden_dim=hidden)
    params = perturb(init_like(jm, rng, net, inp, corr, flow), rng)
    with_mask = block != "basic_no_mask"
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, *a: jm.apply(p, *a, with_mask=with_mask))(
            params, net, inp, corr, flow)
    port = (tup.SmallUpdateBlock if small else tup.BasicUpdateBlock)(
        corr_ch, hidden, context).eval()
    port.load_state_dict(raft_update_state_dict_from_jax(
        params["params"], small=small), strict=True)
    with torch.no_grad():
        got = port(*map(nchw, (net, inp, corr, flow)), with_mask=with_mask)
    for name, g, w in zip(("net", "mask", "delta"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            check(g, w, 1e-4, f"{block} {name}")
    assert (got[1] is None) == (small or not with_mask)


def test_upflow8_matches_jax():
    flow = np.random.RandomState(2).randn(2, 5, 7, 2).astype(np.float32)
    check(traft.upflow8(nchw(flow)), jraft.upflow8(flow), 1e-5, "upflow8")


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    mask = rng.randn(2, 5, 7, 64 * 9).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jraft.convex_upsample(flow, mask)
    check(traft.convex_upsample(nchw(flow), nchw(mask)), want, 1e-5,
          "convex_upsample")


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(70, 99), (64, 96), (436, 1024)])
def test_padder_matches_jax(mode, hw):
    x = np.random.RandomState(4).randn(1, *hw, 3).astype(np.float32)
    jp, tp = JPadder(x.shape, mode=mode), traft.Padder((1, 3) + hw, mode=mode)
    padded = tp.pad(nchw(x))
    close(padded, np.moveaxis(np.asarray(jp.pad(x)), -1, 1), 0.0)
    assert padded.shape[-2] % 8 == 0 and padded.shape[-1] % 8 == 0
    a, b = tp.pad(nchw(x), nchw(x))
    close(tp.unpad(a), np.moveaxis(x, -1, 1), 0.0)
    close(tp.unpad(b), np.moveaxis(np.asarray(jp.unpad(jp.pad(x))), -1, 1),
          0.0)


# ----------------------------------------------------------------------
# the whole model
# ----------------------------------------------------------------------
TINY = dict(hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=2)
CONFIGS = {"tiny": (TINY, False), "standard": ({}, False),
           "small": (dict(hidden_dim=96, context_dim=64, corr_levels=4,
                          corr_radius=3, small=True), True)}
ITERS = 2


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, perturbed variables, the port loaded with them)."""
    out = {}
    for name, (kw, small) in CONFIGS.items():
        rng = np.random.RandomState(10)
        jm = jraft.RAFTBase(**kw)
        f = np.zeros((1, 64, 64, 3), np.float32)
        v = perturb(init_like(jm, rng, f, f, iters=1), rng)
        port = traft.built(traft.RAFTBase(**kw), torch.float32)
        port.load_state_dict(raft_state_dict_from_jax(v, small), strict=True)
        out[name] = (jm, v, port)
    return out


def frame_pair(H, W, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
                 for _ in range(2))


# (config, H, W, path): "list" returns every step's flow, "only_last" the
# serving path, "flow_init" the list from a non-zero start
MODEL_CASES = [("tiny", 64, 64, "list"), ("tiny", 64, 96, "only_last"),
               ("tiny", 64, 96, "flow_init"), ("standard", 64, 96, "list"),
               ("standard", 64, 96, "only_last"), ("small", 64, 96, "list"),
               ("small", 64, 96, "only_last")]


@pytest.mark.parametrize("name,H,W,path", MODEL_CASES,
                         ids=["-".join(map(str, c)) for c in MODEL_CASES])
def test_raft_matches_flax(models, name, H, W, path):
    jm, v, port = models[name]
    f1, f2 = frame_pair(H, W, seed=11)
    kw = dict(iters=ITERS, only_last=path == "only_last")
    init = None
    if path == "flow_init":
        init = np.random.RandomState(12).uniform(
            -2, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, a, b, i: jm.apply(v, a, b, flow_init=i,
                                                   **kw))(v, f1, f2, init)
    with torch.no_grad():
        got = port(nchw(f1), nchw(f2), flow_init=None if init is None
                   else nchw(init), **kw)
    if path == "only_last":
        check(got, want, 1e-4, f"{name} {H}x{W} only_last")
        return
    assert len(got) == len(want) == ITERS
    for i, (g, w) in enumerate(zip(got, want)):
        check(g, w, 1e-4, f"{name} {H}x{W} {path} step {i}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_only_last_matches_final_flow(models, name):
    """The serving path (no mask head before the last step, one upsample)
    gives the list's last flow, to 1e-5 relative, in float32."""
    port = models[name][2]
    f1, f2 = map(nchw, frame_pair(64, 96, seed=13))
    with torch.no_grad():
        flows = port(f1, f2, iters=3)
        last = port(f1, f2, iters=3, only_last=True)
        one = port(f1, f2, iters=1, only_last=True)
    rel = float((last - flows[-1]).abs().max() / flows[-1].abs().max())
    print(f"{name}: only_last vs flows[-1] relative {rel:.3e}")
    assert last.shape == flows[-1].shape == (1, 2, 64, 96) and rel < 1e-5
    assert one.shape == last.shape


def test_raft_bfloat16_follows_flax(models):
    """The bfloat16 model (convs in bf16; GRU state, coordinates, volume and
    norms' statistics in float32; the serving path's pyramid in bf16)
    against the JAX model at dtype bfloat16 on the same variables."""
    _, v, port = models["tiny"]
    jm = jraft.RAFTBase(dtype=jnp.bfloat16, **TINY)
    f1, f2 = frame_pair(64, 96, seed=14)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, iters=ITERS,
                                            only_last=True))(v, f1, f2)
    m16 = traft.built(traft.RAFTBase(**TINY, device="cpu"), torch.bfloat16)
    m16.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = m16(nchw(f1), nchw(f2), iters=ITERS, only_last=True)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    check(got, want, 3e-2, "tiny bf16 only_last")


def test_inference_returns_flows(models):
    flows = np.random.RandomState(15).randn(2, 16, 24, 2).astype(np.float32)
    want = jraft.inference([flows])
    got = traft.inference([nchw(flows)])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g, tsc.Flow) and g.names == ("C", "H", "W")
        same(g, w)
    same(traft.inference(nchw(flows))[1], want[1])


def test_serving_slice_matches_jax(models):
    """uint8 frames -> Frame -> norm_minmax_sym -> batch -> Padder (60x90
    is not a multiple of 8) -> RAFT only_last -> unpad -> inference, in
    both packages."""
    jm, v, port = models["tiny"]
    rng = np.random.RandomState(16)
    images = [rng.randint(0, 256, (3, 60, 90)).astype(np.uint8)
              for _ in range(4)]
    jf = [jsc.Frame(x.astype(np.float32)).norm_minmax_sym() for x in images]
    tf = [tsc.Frame(torch.from_numpy(x)).norm_minmax_sym() for x in images]
    j1, j2 = (np.asarray(jsc.batch_list(jf[k::2]).as_layout(
        ("B", "H", "W", "C"))) for k in (0, 1))
    jp = JPadder(j1.shape)
    with jax.default_matmul_precision("highest"):
        want = jraft.inference(jp.unpad(jax.jit(
            lambda v, a, b: jm.apply(v, a, b, iters=ITERS, only_last=True))(
            v, *jp.pad(jnp.asarray(j1), jnp.asarray(j2)))))
    t1, t2 = (tsc.batch_list(tf[k::2]).as_layout(("B", "C", "H", "W"))
              for k in (0, 1))
    tp = traft.Padder(t1.shape)
    with torch.no_grad():
        got = traft.inference(tp.unpad(port(*tp.pad(t1, t2), iters=ITERS,
                                            only_last=True)))
    assert [g.shape for g in got] == [(2, 60, 90)] * 2
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(w.as_numpy()).max()))
        same(g, w, rtol=0.0, atol=1e-4 * scale)


# ----------------------------------------------------------------------
# Flow, the Sintel sample, eval_on_sintel
# ----------------------------------------------------------------------
def flows():
    rng = np.random.RandomState(17)
    x = rng.randn(2, 12, 16).astype(np.float32)
    occ = (rng.rand(1, 12, 16) > 0.5).astype(np.float32)
    return (jsc.Flow(x, occlusion=jsc.Mask(occ)),
            tsc.Flow(torch.from_numpy(x), occlusion=tsc.Mask(
                torch.from_numpy(occ))))


@pytest.mark.parametrize("op", ["resize", "hflip", "vflip"])
def test_flow_geometry_matches_jax(op):
    jf, tf = flows()
    if op == "resize":
        jo, to = jf.resize((24, 40)), tf.resize((24, 40))
        assert to.shape == (2, 24, 40)
        same(to, jo, rtol=1e-5)
    else:
        same(getattr(tf, op)(), getattr(jf, op)())


def test_sintel_sample_matches_jax():
    jds = JSintel(sample=True, sequence_size=2)
    tds = SintelFlowDataset(sample=True)
    assert len(tds) == len(jds) == 6
    for idx in (0, 5):
        got, want = tds[idx], jds[idx]
        same(got, want)
        assert got.names == ("T", "C", "H", "W")
        flow = got[0].get_child("flow")["flow_forward"]
        assert isinstance(flow, tsc.Flow) and flow.shape == (2, 96, 128)
        assert got[1].get_child("flow") is None


def test_eval_on_sintel_cpu(capsys):
    epe = eval_on_sintel.main(["--cpu", "--sample", "--tiny",
                               "--limit_samples", "2"])
    assert np.isfinite(epe) and epe > 0
    assert "over 2 pairs" in capsys.readouterr().out


# ----------------------------------------------------------------------
# factories and weights
# ----------------------------------------------------------------------
@pytest.mark.parametrize("factory", ["raft", "raft_small"])
def test_factories_build_on_the_card_or_where_named(factory, monkeypatch):
    make = getattr(traft, factory)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make()
    model = make(torch.bfloat16, device="cpu")
    assert not model.training
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert model.update_block.flow_head.conv1.weight.dtype == torch.bfloat16
    assert model.cnet.norm1.weight.dtype == torch.float32
    assert model.cnet.norm1.running_var.dtype == torch.float32
    assert model.fnet.conv1.weight.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("small", [False, True], ids=["raft", "raft_small"])
def test_weights_round_trip(small):
    """convert_raft_checkpoint inverts raft_state_dict_from_jax bit for bit,
    and the state_dict loads strictly into the factory's model."""
    rng = np.random.RandomState(18)
    jm = jraft.raft_small() if small else jraft.RAFT()
    f = np.zeros((1, 64, 64, 3), np.float32)
    v = perturb(init_like(jm, rng, f, f, iters=1), rng)
    sd = raft_state_dict_from_jax(v, small)
    back = convert_raft_checkpoint({k: x.numpy() for k, x in sd.items()},
                                   small=small)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(v)]
    for (p, a), (_, b) in zip(flat(back), flat(v)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p
    model = (traft.raft_small if small else traft.raft)(device="cpu")
    model.load_state_dict(sd, strict=True)
    assert "cnet.layer2.0.norm3.running_var" in sd \
        or "cnet.layer2.0.norm4.running_var" in sd
