"""The named-weights registry of the port (``utils/weights.py``:
``WEIGHT_REGISTRY``, ``resolve_weights``, ``load_weights``) against the JAX
package's, on ``.pth`` files that the tests write (nothing is fetched).

Each file is written from a seeded JAX model through the port's
``*_state_dict_from_jax``, so it holds the reference's key layout, under a
registry name in both packages' ``WEIGHTS_DIR`` (HOME and both directories
under ``tmp_path``). Loaded by name in both packages (JAX's
``load_weights`` with its converter, the port's ``load_weights``), the
forwards agree within 1e-4 * max(1, max|ref|) in float32 (HIGHEST on the
JAX side; the torch side on the CPU, which has no TF32): DETR and Deformable-DETR
(refine) with full ResNet-50 stages (the JAX converters'), and RAFT. The
errors: a missing key, a shape that differs, an unknown name and a
registry name without its file. Then the commands: ``eval_on_coco
--weights <name>`` against JAX's eval loop on the same weights (its init
patched to return them: JAX's converters take full widths only), and both
packages' ``eval_on_sintel --weights <name>``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu.models import panoptic as jpan
from aloception_tpu.models.raft import raft as jraft
from aloception_tpu.utils import weights as jw
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models import detr as tdetr
from aloception_tpu_torch.models import raft as traft
from aloception_tpu_torch.utils import weights as tw

from test_torch_panoptic import TINY as EVAL_TINY
from test_torch_panoptic import _recorded, panoptic_pair
from torch_parity import close, init_like, perturb, t, with_7x7_stem

SMALL = dict(num_classes=10, hidden_dim=64, num_queries=20, nheads=4,
             num_encoder_layers=2, num_decoder_layers=3, dim_feedforward=128)
DIMS = dict(d_model=64, nheads=4, num_enc=2, num_dec=3)
RAFT_TINY = dict(hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=2)


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """Both packages' WEIGHTS_DIR under the test's HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))
    wdir = tmp_path / ".aloception_tpu" / "weights"
    wdir.mkdir(parents=True)
    monkeypatch.setattr(jw, "WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(tw, "WEIGHTS_DIR", str(wdir))
    return wdir


def detector_inputs(seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    mask = np.zeros((2, 64, 96), np.float32)
    mask[1, :, 72:] = 1.0
    return images, mask


def make_case(name):
    """(registry name, JAX model, its variables, the port's state dict, the
    JAX converter, a port model, the JAX forward, the port's forward, the
    outputs compared)."""
    rng = np.random.RandomState(7)
    if name == "raft":
        jm = jraft.RAFTBase(**RAFT_TINY)
        f = np.zeros((1, 64, 64, 3), np.float32)
        v = perturb(init_like(jm, rng, f, f, iters=1), rng)
        sd = tw.raft_state_dict_from_jax(v)
        port = traft.built(traft.RAFTBase(device="cpu", **RAFT_TINY),
                           torch.float32)
        pair = tuple(rng.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
                     for _ in range(2))
        return ("raft-things", jm, v, sd,
                partial(jw.convert_raft_checkpoint, small=False), port,
                lambda p: jm.apply(p, *pair, iters=2)[-1],
                lambda: port(*(t(x).permute(0, 3, 1, 2) for x in pair),
                             iters=2)[-1].permute(0, 2, 3, 1))
    images, mask = detector_inputs(8)
    if name == "detr":
        jm = jdetr.Detr(space_to_depth=False, **SMALL)
        port = tdetr.Detr(device="cpu", **SMALL)
        convert = partial(jw.convert_detr_checkpoint, space_to_depth=False,
                          **DIMS)
        to_sd, reg = tw.detr_state_dict_from_jax, "detr-r50"
    else:
        jm = jdd.DeformableDETR(with_box_refine=True, space_to_depth=False,
                                **SMALL)
        port = tdd.DeformableDETR(with_box_refine=True, device="cpu", **SMALL)
        convert = partial(jw.convert_deformable_checkpoint,
                          with_box_refine=True, space_to_depth=False, **DIMS)
        to_sd = partial(tw.deformable_state_dict_from_jax,
                        with_box_refine=True)
        reg = "deformable-detr-r50-refinement"
    v = perturb(init_like(jm, rng, images[:1], mask[:1]), rng)
    port.eval()
    return (reg, jm, v, to_sd(v), convert, port,
            lambda p: jm.apply(p, images, mask),
            lambda: port(t(images), t(mask)))


@pytest.mark.parametrize("name", ["detr", "deformable_refine", "raft"])
def test_load_weights_by_name_matches_jax(registry, name):
    reg, jm, v, sd, convert, port, jfwd, tfwd = make_case(name)
    torch.save(sd, registry / tw.WEIGHT_REGISTRY[reg])
    assert tw.resolve_weights(reg) == jw.resolve_weights(reg) \
        == str(registry / tw.WEIGHT_REGISTRY[reg])
    loaded = jw.load_weights(jax.device_get(v), reg, converter=convert)
    assert tw.load_weights(port, reg) is port
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jfwd)(loaded))
    with torch.no_grad():
        got = tfwd()
    if name == "raft":
        pairs = [(got, want)]
    else:
        pairs = [(got[k], want[k]) for k in ("pred_logits", "pred_boxes")]
    for g, w in pairs:
        w = np.asarray(w, np.float32)
        close(g, w, 1e-4 * max(1.0, float(np.abs(w).max())))


def test_registry_names_are_the_reference_s():
    assert tw.WEIGHT_REGISTRY == jw.WEIGHT_REGISTRY
    assert len(tw.WEIGHT_REGISTRY) == 9
    assert tw.WEIGHTS_DIR.endswith("/.aloception_tpu/weights")


@pytest.mark.parametrize("fault", ["missing_key", "shape"])
def test_load_weights_refuses_what_jax_refuses(registry, fault):
    """A key that the model has and the file lacks, or a shape that
    differs: the port raises ``ValueError`` and leaves the model untouched;
    JAX raises too (``KeyError`` where its converter reads the missing key
    itself, ``ValueError`` from its checks)."""
    reg, jm, v, sd, convert, port, _, _ = make_case("detr")
    key = "transformer.decoder.norm.weight"
    if fault == "missing_key":
        del sd[key]
    else:
        sd[key] = torch.zeros(7)
    torch.save(sd, registry / tw.WEIGHT_REGISTRY[reg])
    before = {k: x.clone() for k, x in port.state_dict().items()}
    with pytest.raises((KeyError, ValueError)):
        jw.load_weights(jax.device_get(v), reg, converter=convert)
    with pytest.raises(ValueError):
        tw.load_weights(port, reg)
    for k, x in port.state_dict().items():
        assert torch.equal(x, before[k]), k


@pytest.mark.parametrize("what", ["unknown", "registered_without_file"])
def test_resolve_weights_raises_as_jax_does(registry, what):
    name = "no-such-weights" if what == "unknown" else "raft-sintel"
    for module in (jw, tw):
        with pytest.raises(FileNotFoundError) as err:
            module.resolve_weights(name)
        if what == "unknown":
            assert "unknown weights" in str(err.value)
        else:
            assert str(registry / "raft-sintel.pth") in str(err.value)


# ----------------------------------------------------------------------
# the commands
# ----------------------------------------------------------------------
def eval_detector(kind, seed=5):
    """eval_on_coco's tiny ``kind`` detector (JAX model, params)."""
    rng = np.random.RandomState(seed)
    tiny = {k: v for k, v in EVAL_TINY.items() if k != "return_intermediate"}
    jm = jdetr.Detr(**tiny) if kind == "detr" else jdd.DeformableDETR(
        with_box_refine=True, **tiny)
    images = rng.randn(1, 96, 128, 3).astype(np.float32)
    mask = np.zeros((1, 96, 128), np.float32)
    params = perturb(init_like(jm, rng, images, mask)["params"], rng)
    with_7x7_stem(params["backbone"], rng)
    return jm, params


@pytest.mark.parametrize("model", ["detr", "deformable", "panoptic"])
def test_eval_on_coco_weights_by_name_matches_jax(registry, model,
                                                  monkeypatch):
    """``eval_on_coco --weights <name>`` reads the registry's file: the same
    per-frame detections (1e-5) and AP as JAX's eval loop run on the
    weights that file was written from."""
    import aloception_tpu.metrics as jmetrics
    import aloception_tpu_torch.metrics as tmetrics
    from aloception_tpu.commands import eval_on_coco as jeval
    from aloception_tpu_torch.commands import eval_on_coco as teval
    if model == "panoptic":
        _, params, _ = panoptic_pair("detr", seed=5)
        cls, reg = jpan.DetrPanoptic, "detr-r50-panoptic"
        sd = tw.panoptic_state_dict_from_jax(params)
    elif model == "detr":
        _, params = eval_detector("detr")
        cls, reg = jdetr.Detr, "detr-r50"
        sd = tw.detr_state_dict_from_jax(params)
    else:
        _, params = eval_detector("deformable")
        cls, reg = jdd.DeformableDETR, "deformable-detr-r50-refinement"
        sd = tw.deformable_state_dict_from_jax(params, True)
    torch.save(sd, registry / tw.WEIGHT_REGISTRY[reg])
    monkeypatch.setattr(cls, "init", lambda self, *a, **k: {"params": params})
    argv = ["--cpu", "--sample", "--tiny", "--model", model,
            "--limit_batches", "1", "--size", "96", "128"]
    jcalls, tcalls = [], []
    _recorded(monkeypatch, jmetrics, jcalls)
    _recorded(monkeypatch, tmetrics, tcalls)
    with jax.default_matmul_precision("highest"):
        want = jeval.main(argv)
    got = teval.main(argv + ["--weights", reg])
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert tcalls
    for (name, _, tp, _), (_, _, jp, _) in zip(tcalls, jcalls):
        if name == "ApMetrics":
            close(tp.array, jp.as_numpy(), 1e-5)
            close(tp.labels.scores, jp.get_child("labels").scores, 1e-5)
    assert got == want


def test_eval_on_coco_panoptic_deformable_weights_exits(registry):
    """The reference publishes no Deformable panoptic checkpoint: both
    packages exit."""
    from aloception_tpu.commands import eval_on_coco as jeval
    from aloception_tpu_torch.commands import eval_on_coco as teval
    argv = ["--cpu", "--sample", "--tiny", "--model", "panoptic_deformable",
            "--limit_batches", "1", "--size", "64", "96", "--weights",
            "detr-r50-panoptic"]
    for main in (jeval.main, teval.main):
        with pytest.raises(SystemExit, match="deformable-panoptic"):
            main(argv)


def test_eval_on_sintel_weights_by_name_matches_jax(registry):
    """Both packages' ``eval_on_sintel --weights raft-things`` on the
    sample: the EPE within 1e-4 relative."""
    from aloception_tpu.commands import eval_on_sintel as jeval
    from aloception_tpu_torch.commands import eval_on_sintel as teval
    model = traft.built(traft.RAFTBase(
        device="cpu", generator=torch.Generator().manual_seed(4),
        **RAFT_TINY), torch.float32)
    torch.save(model.state_dict(), registry / "raft-things.pth")
    argv = ["--cpu", "--sample", "--tiny", "--iters", "2", "--weights",
            "raft-things", "--limit_samples", "2"]
    got, want = teval.main(argv), jeval.main(argv)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
