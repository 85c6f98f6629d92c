"""The export subsystem of the PyTorch port against the JAX package on the
CPU: the MSDA operator (``opcheck``, its node in the exported graph, its
gradients), the four exporters against the JAX exporters on the same
parameters and inputs, the ``bf16`` profile, the serving handler and
``export_model``. The package on the card: ``test_torch_export_card.py``.

JAX parameters are drawn by ``init_like``, moved by noise and carried into
the port by the ``*_state_dict_from_jax`` converters; the JAX side runs with
``Precision.HIGHEST`` (its Pallas MSDA in interpret mode). Tolerances:
fp32 1e-4 * max(1, max|ref|) (summation order and the two frameworks'
kernels). Two AOTInductor packages are compiled, both of tiny models and
shared through module-scoped fixtures (tiny DETR by ``export_model``,
tiny Deformable-DETR by its exporter); the other tests use the
``ExportedProgram``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu import export as jexport
from aloception_tpu.export.production import ModelHandler as JaxHandler
from aloception_tpu.models import panoptic as jpan
from aloception_tpu.models.deformable_detr import DeformableDETR as JaxDeformable
from aloception_tpu.models.detr import Detr as JaxDetr
from aloception_tpu.models.raft import RAFTBase as JaxRAFT
from aloception_tpu_torch import export as texport
from aloception_tpu_torch.export.production import ModelHandler
from aloception_tpu_torch.models import panoptic as tpan
from aloception_tpu_torch.models.deformable_detr import DeformableDETR
from aloception_tpu_torch.models.detr import Detr
from aloception_tpu_torch.models.raft import RAFTBase, built
from aloception_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_torch)
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax,
                                                panoptic_state_dict_from_jax,
                                                raft_state_dict_from_jax)

from torch_parity import init_like, perturb, t, with_7x7_stem

# the JAX CLI's tiny configuration (commands/export_model.py)
TINY = dict(hidden_dim=64, num_queries=16, nheads=4, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=64, stage_sizes=(1, 1, 1, 1))
CLASSES = 4
HW = (64, 96)
RAFT_TINY = dict(hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=2)
RAFT_HW, RAFT_ITERS = (64, 64), 2


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _same_outputs(got, want, tol=1e-4):
    """Dict (or array) outputs within tol * max(1, max|ref|), key by key."""
    if not isinstance(want, dict):
        got, want = {"out": got}, {"out": want}
    assert set(got) == set(want)
    for k in want:
        err = _rel_err(got[k], want[k])
        assert err <= tol, (k, err, tol)


def _images(batch, seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, *HW, 3).astype(np.float32)
    mask = np.zeros((batch,) + HW, np.float32)
    return images, mask


# -- pairs: the JAX model, its variables, the port loaded with them --------

@pytest.fixture(scope="module")
def detr_pair():
    rng = np.random.RandomState(0)
    jm = JaxDetr(num_classes=CLASSES, **TINY)
    x, m = _images(1, 0)
    v = {"params": perturb(init_like(jm, rng, x, m)["params"], rng)}
    with_7x7_stem(v["params"]["backbone"], rng)
    port = Detr(num_classes=CLASSES, device="cpu", **TINY).eval()
    port.load_state_dict(detr_state_dict_from_jax(v), strict=True)
    return jm, v, port


@pytest.fixture(scope="module")
def deformable_pair():
    rng = np.random.RandomState(1)
    jm = JaxDeformable(num_classes=CLASSES, with_box_refine=True, **TINY)
    x, m = _images(1, 0)
    v = {"params": perturb(init_like(jm, rng, x, m)["params"], rng)}
    with_7x7_stem(v["params"]["backbone"], rng)
    port = DeformableDETR(num_classes=CLASSES, with_box_refine=True,
                          device="cpu", **TINY).eval()
    port.load_state_dict(deformable_state_dict_from_jax(v, True), strict=True)
    return jm, v, port


# -- the operator -----------------------------------------------------------

def _msda_inputs(seed=0, requires_grad=False):
    rng = np.random.RandomState(seed)
    shapes = ((6, 8), (3, 4), (2, 2), (1, 1))
    len_v = sum(h * w for h, w in shapes)
    w = rng.uniform(0, 1, (2, 9, 4, 4, 4)).astype(np.float32)
    arrays = (rng.randn(2, len_v, 4, 8).astype(np.float32),
              rng.uniform(-0.2, 1.2, (2, 9, 4, 4, 4, 2)).astype(np.float32),
              w / w.sum((3, 4), keepdims=True))
    value, loc, w = (torch.from_numpy(a).requires_grad_(requires_grad)
                     for a in arrays)
    return value, shapes, loc, w


@pytest.mark.parametrize("requires_grad", [False, True])
def test_op_opcheck(requires_grad):
    """Schema, fake (meta) kernel and autograd registration of
    ``aloception_tpu_torch::ms_deform_attn``, by ``torch.library.opcheck``."""
    value, shapes, loc, w = _msda_inputs(requires_grad=requires_grad)
    torch.library.opcheck(
        torch.ops.aloception_tpu_torch.ms_deform_attn.default,
        (value, [s for hw in shapes for s in hw], loc, w),
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor", "test_aot_dispatch_static"))


def test_op_gradients_match_plain_autograd():
    """Gradients through the operator (the registered recompute backward)
    equal plain autograd's through ``ms_deform_attn_torch``: the same
    computation, so exactly."""
    cot = torch.from_numpy(np.random.RandomState(2).randn(2, 9, 32)
                           .astype(np.float32))
    grads = []
    for fn in (ms_deform_attn, ms_deform_attn_torch):
        value, shapes, loc, w = _msda_inputs(requires_grad=True)
        (fn(value, shapes, loc, w) * cot).sum().backward()
        grads.append([value.grad, loc.grad, w.grad])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_op_is_a_node_of_the_exported_deformable_graph(deformable_pair):
    """``torch.export`` records MSDA as the operator, one node per call (an
    encoder and a decoder layer), and the fake kernel gives its shape."""
    _, _, port = deformable_pair
    exported, _, _ = texport.DeformableDetrExporter(
        port, input_shape=HW).export_program()
    nodes = [n for n in exported.graph.nodes
             if n.target is torch.ops.aloception_tpu_torch.ms_deform_attn.default]
    assert len(nodes) == 2
    for n in nodes:
        value = n.args[0].meta["val"]
        assert n.meta["val"].shape == (1, n.args[2].meta["val"].shape[1],
                                       value.shape[2] * value.shape[3])


# -- the exporters against the JAX exporters ---------------------------------

def _jax_exported(exporter, inputs):
    """The JAX exporter's artifact, reloaded and called on ``inputs``."""
    with jax.default_matmul_precision("highest"):
        artifact = exporter.export_engine(sanity_check=False)
        return jax.device_get(jexport.Executor(artifact)(*inputs))


def _port_exported(exporter, inputs):
    """The port's ExportedProgram called on ``inputs``."""
    exported, _, _ = exporter.export_program()
    with torch.no_grad():
        return exported.module()(*inputs)


@pytest.mark.parametrize("kind", ["detr", "deformable"])
def test_detector_exporter_matches_jax(kind, detr_pair, deformable_pair):
    jm, v, port = detr_pair if kind == "detr" else deformable_pair
    jcls, tcls = ((jexport.DetrExporter, texport.DetrExporter)
                  if kind == "detr" else (jexport.DeformableDetrExporter,
                                          texport.DeformableDetrExporter))
    images, mask = _images(2, 3)
    mask[1, :, 70:] = 1.0
    want = _jax_exported(jcls(jm, v, input_shape=HW, batch_size=2),
                         (images, mask))
    got = _port_exported(tcls(port, input_shape=HW, batch_size=2),
                         (t(images), t(mask)))
    _same_outputs(got, want)


def test_panoptic_exporter_matches_jax():
    rng = np.random.RandomState(4)
    jdet = JaxDetr(num_classes=CLASSES, return_intermediate=True, **TINY)
    jm = jpan.DetrPanoptic(detector=jdet, num_classes=CLASSES)
    images, mask = _images(1, 5)
    params = perturb(init_like(jm, rng, images, mask)["params"], rng)
    with_7x7_stem(params["detector"]["backbone"], rng)
    port = tpan.DetrPanoptic(
        Detr(num_classes=CLASSES, return_intermediate=True, device="cpu",
             **TINY).eval(), num_classes=CLASSES)
    port.load_state_dict(panoptic_state_dict_from_jax(params), strict=True)
    head = jpan.PanopticHead(hidden_dim=TINY["hidden_dim"],
                             num_heads=TINY["nheads"])
    want = _jax_exported(
        jexport.PanopticExporter(jdet, {"params": params["detector"]}, head,
                                 {"params": params["panoptic_head"]},
                                 input_shape=HW), (images, mask))
    got = _port_exported(texport.PanopticExporter(port.detr, port,
                                                  input_shape=HW),
                         (t(images), t(mask)))
    _same_outputs(got, want)


def test_raft_exporter_matches_jax():
    """Fixed iterations, ``only_last``: the port's frames are NCHW, the JAX
    exporter's NHWC."""
    rng = np.random.RandomState(6)
    jm = JaxRAFT(**RAFT_TINY)
    f = np.zeros((1,) + RAFT_HW + (3,), np.float32)
    v = perturb(init_like(jm, rng, f, f, iters=1), rng)
    port = built(RAFTBase(device="cpu", **RAFT_TINY), torch.float32)
    port.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    f1, f2 = (rng.uniform(-1, 1, (1,) + RAFT_HW + (3,)).astype(np.float32)
              for _ in range(2))
    want = _jax_exported(jexport.RAFTExporter(jm, v, input_shape=RAFT_HW,
                                              iters=RAFT_ITERS), (f1, f2))
    got = _port_exported(
        texport.RAFTExporter(port, input_shape=RAFT_HW, iters=RAFT_ITERS),
        (t(f1).permute(0, 3, 1, 2), t(f2).permute(0, 3, 1, 2)))
    # the JAX flow is NHWC
    _same_outputs(got.permute(0, 2, 3, 1), want)


def _bf16_round(tree):
    return jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)), tree)


@pytest.mark.parametrize("kind", ["detr", "deformable"])
def test_bf16_profile_follows_jax(kind, detr_pair, deformable_pair):
    """The ``bf16`` profile computes in float32 from parameters rounded
    through bfloat16, as the JAX profile does (flax promotes them back to
    the models' float32). The one place JAX computes in bfloat16 is the
    FrozenBatchNorm fold (``scale / sqrt(var + eps)``, ``bias - mean * w``
    on bf16 parameters); the port folds in float32. So the port is held
    to 1e-4 against the JAX model on the rounded parameters in float32
    (the same computation), and against the JAX bf16 artifact within the
    gap that the bf16 fold makes there (measured: JAX's bf16 artifact
    against its own float32 fold) plus that 1e-4."""
    jm, v, port = detr_pair if kind == "detr" else deformable_pair
    jcls, tcls = ((jexport.DetrExporter, texport.DetrExporter)
                  if kind == "detr" else (jexport.DeformableDetrExporter,
                                          texport.DeformableDetrExporter))
    images, mask = _images(1, 7)
    jax_bf16 = _jax_exported(jcls(jm, v, input_shape=HW, precision="bf16"),
                             (images, mask))
    jax_f32_fold = _jax_exported(jcls(jm, _bf16_round(v), input_shape=HW),
                                 (images, mask))
    got = _port_exported(tcls(port, input_shape=HW, precision="bf16"),
                         (t(images), t(mask)))
    _same_outputs(got, jax_f32_fold)
    for k in jax_bf16:
        fold_gap = _rel_err(jax_f32_fold[k], jax_bf16[k])
        assert _rel_err(got[k], jax_bf16[k]) <= fold_gap + 1e-4, k
    # and the profile did round: the fp32 export differs
    fp32 = _port_exported(tcls(port, input_shape=HW), (t(images), t(mask)))
    assert not torch.equal(fp32["pred_logits"], got["pred_logits"])


@pytest.mark.parametrize("cxx", ["/bin/false", "/no/such/g++"])
def test_host_compiler_skips_one_that_cannot_link_openmp(cxx, monkeypatch):
    """A ``$CXX`` that cannot link an OpenMP program (the card machine's
    partial toolchain, or none at all) gives way to the ``g++`` on PATH;
    with no usable compiler the export raises."""
    import shutil
    from aloception_tpu_torch.export import base_exporter
    monkeypatch.setenv("CXX", cxx)
    assert base_exporter.host_compiler() == shutil.which("g++")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="links OpenMP"):
        base_exporter.host_compiler()


# -- AOTInductor packages ----------------------------------------------------

@pytest.fixture(scope="module")
def deformable_package(deformable_pair, tmp_path_factory):
    """The tiny Deformable-DETR compiled by AOTInductor on the CPU."""
    _, _, port = deformable_pair
    exporter = texport.DeformableDetrExporter(port, input_shape=HW)
    path = str(tmp_path_factory.mktemp("pkg") / "deformable.pt2")
    artifact = exporter.export_engine(path=path, sanity_check=True)
    return exporter, artifact, path


def test_package_runs_the_operator(deformable_package, deformable_pair):
    """The package reloaded by ``Executor`` calls the MSDA operator (its CPU
    kernel here: 2 calls a forward, seen by the profiler) and agrees with
    the JAX exporter's artifact."""
    jm, v, _ = deformable_pair
    _, artifact, path = deformable_package
    assert os.path.exists(path) and os.path.exists(path + ".json")
    assert artifact.meta["sanity_max_diff"] <= 1e-2
    executor = texport.Executor(path, profiling=True)
    assert executor.meta["name"] == "deformable-detr"
    images, mask = _images(1, 8)
    with torch.profiler.profile() as prof:
        got = executor(t(images), t(mask))
    calls = sum(e.count for e in prof.key_averages()
                if e.key == "aloception_tpu_torch::ms_deform_attn")
    assert calls == 2
    assert executor.profiler.report()["calls"] == 1
    want = _jax_exported(jexport.DeformableDetrExporter(jm, v, input_shape=HW),
                         (images, mask))
    _same_outputs(got, want)


def test_sanity_check_catches_a_mismatch(deformable_package):
    exporter, artifact, _ = deformable_package
    inputs = exporter.example_inputs()
    module = exporter.build_fn()

    def shifted(*xs):
        return {k: v + 1.0 for k, v in module(*xs).items()}
    with pytest.raises(AssertionError, match="sanity check failed"):
        exporter.sanity_check(artifact, inputs, shifted)


def test_profile_counts_msda_flops(deformable_package):
    """FLOPs by ``FlopCounterMode`` include the operator's, counted as the
    bound counts them (2 per multiply-add of a corner inside its level)."""
    exporter, _, _ = deformable_package
    report = exporter.profile(n_iters=1)
    # the JAX report's keys: the package's latency, not the eager module's
    assert set(report) == {"latency_ms", "flops", "tflops_s"}
    assert report["latency_ms"] > 0
    from torch.utils.flop_counter import FlopCounterMode
    with torch.enable_grad(), FlopCounterMode(display=False) as counter:
        exporter.build_fn()(*exporter.example_inputs())
    counts = counter.get_flop_counts()["Global"]
    msda = counts[torch.ops.aloception_tpu_torch.ms_deform_attn]
    # at most every corner: 2 * 4 corners * C per weight, C = 64 / 4; the
    # encoder's 128 queries over 128 cells, the decoder's 16
    weights = (128 + TINY["num_queries"]) * TINY["nheads"] * 4 * 4
    assert 0 < msda <= 2 * 4 * 16 * weights
    assert report["flops"] == sum(counts.values())


def test_msda_flops_on_fake_tensors():
    """Where the inputs carry no data (a compiler counting a traced graph
    on fake tensors), the operator's FLOP formula gives the most the shapes
    allow, four corners a point, and does not read the data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    shapes = ((4, 5), (2, 3))
    with FakeTensorMode():
        value = torch.empty(2, 26, 4, 8)
        loc = torch.empty(2, 7, 4, 2, 3, 2)
        w = torch.empty(2, 7, 4, 2, 3)
        with FlopCounterMode(display=False) as counter:
            out = ms_deform_attn(value, shapes, loc, w)
    assert out.shape == (2, 7, 32)
    assert counter.get_total_flops() == 2 * 4 * w.numel() * 8


@pytest.fixture(scope="module")
def cli_package(detr_pair, tmp_path_factory):
    """``export_model --cpu --tiny --model detr --batch_size 2`` on a
    checkpoint holding the JAX model's parameters."""
    from aloception_tpu_torch.commands import export_model
    from aloception_tpu_torch.train import CheckpointManager
    _, _, port = detr_pair
    root = tmp_path_factory.mktemp("cli")
    CheckpointManager(str(root / "ckpt")).save(
        3, {"model": port.state_dict(), "step": 3})
    out = str(root / "detr.pt2")
    exporter, report = export_model.main([
        "--cpu", "--tiny", "--model", "detr", "--num_classes", str(CLASSES),
        "--batch_size", "2", "--size", *map(str, HW), "--out", out,
        "--ckpt_dir", str(root / "ckpt"), "--profile"])
    return exporter, report, out


def test_export_model_cli(cli_package, capsys):
    exporter, report, out = cli_package
    assert exporter.artifact.package_path == out
    assert os.path.exists(out) and os.path.exists(out + ".json")
    with open(out + ".json") as f:
        side = json.load(f)
    assert side["meta"]["name"] == "detr" and side["meta"]["device"] == "cpu"
    assert side["input_specs"] == [["(2, 64, 96, 3)", "float32"],
                                   ["(2, 64, 96)", "float32"]]
    assert report["flops"] > 0 and report["latency_ms"] > 0


def test_export_model_needs_a_card_or_cpu(monkeypatch, tmp_path):
    from aloception_tpu_torch.commands import export_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        export_model.main(["--tiny", "--out", str(tmp_path / "x.pt2")])


def test_handler_matches_jax(cli_package, detr_pair, tmp_path):
    """The port's handler on the ``export_model`` package (the JAX model's
    parameters, restored from the checkpoint) gives JAX's JSON for uint8
    arrays of other sizes: labels and names equal, scores and boxes within
    1e-4."""
    jm, v, _ = detr_pair
    _, _, out = cli_package
    jpath = str(tmp_path / "detr.stablehlo")
    with jax.default_matmul_precision("highest"):
        jexport.DetrExporter(jm, v, input_shape=HW, batch_size=2
                             ).export_engine(path=jpath, sanity_check=False)
    names = ["a", "b", "c", "d", "bg"]
    rng = np.random.RandomState(9)
    batch = [rng.randint(0, 255, (100, 120, 3)).astype(np.uint8),
             rng.randint(0, 255, (70, 150, 3)).astype(np.uint8)]
    results = []
    for cls, path in ((JaxHandler, jpath), (ModelHandler, out)):
        handler = cls(input_size=HW, threshold=0.0, background_class=CLASSES,
                      labels_names=names)
        handler.initialize(path)
        with jax.default_matmul_precision("highest"):
            results.append([json.loads(r) for r in handler.handle(batch)])
    got, want = results
    assert len(got) == len(want) == 2
    assert sum(len(d) for d in want) > 0
    for g_dets, w_dets in zip(got, want):
        assert [d["label"] for d in g_dets] == [d["label"] for d in w_dets]
        for g, w in zip(g_dets, w_dets):
            assert set(g) == {"label", "score", "box_xcyc_rel"}
            assert abs(g["score"] - w["score"]) <= 1e-4
            assert np.abs(np.subtract(g["box_xcyc_rel"],
                                      w["box_xcyc_rel"])).max() <= 1e-4


def test_handler_takes_frames_and_refuses_bytes(cli_package):
    """Frames, arrays and encoded bytes of one image give the same boxes;
    bytes that do not decode are refused with the decoder's reason."""
    import io
    from PIL import Image
    from aloception_tpu_torch.aloscene import Frame, InvalidSampleError
    _, _, out = cli_package
    handler = ModelHandler(input_size=HW, threshold=0.0,
                           background_class=CLASSES)
    handler.initialize(out)
    img = np.random.RandomState(1).randint(0, 255, (80, 90, 3), np.uint8)
    frame = Frame(torch.from_numpy(img).permute(2, 0, 1).float())
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    from_frame, from_array, from_bytes = (
        handler.handle([x, x]) for x in (frame, img, buf.getvalue()))
    assert from_frame == from_array == from_bytes
    with pytest.raises(InvalidSampleError, match="image decoder"):
        handler.preprocess([b"\xff\xd8\xff", img])


def test_handler_runs_on_the_exporters_executor(cli_package):
    """A handler given the package that ``export_model`` loaded for its
    sanity check serves as one that loads it from the path, and times its
    calls."""
    exporter, _, out = cli_package
    img = np.random.RandomState(2).randint(0, 255, (70, 100, 3), np.uint8)
    results = []
    for artifact in (out, exporter.executor):
        handler = ModelHandler(input_size=HW, threshold=0.0,
                               background_class=CLASSES)
        handler.initialize(artifact)
        results.append(handler.handle([img, img]))
    assert results[0] == results[1]
    assert handler.executor is exporter.executor
    assert handler.executor.profiler.report()["calls"] == 1
