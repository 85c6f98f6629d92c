"""The panoptic slice of the PyTorch port against the JAX package on the
CPU: ``MHAttentionMap`` with and without a padding mask,
``MaskHeadSmallConv`` at sizes whose ratios are not 2 (in both memory
layouts), the ``return_intermediate`` dicts of both tiny detectors,
``DetrPanoptic`` on both, ``inference_with_masks``, the masked COCO and the
COCO panoptic samples and the masks' transforms, and the slice as a whole:
the same tiny weights and sample batches through both packages'
``eval_on_coco`` loops. Parameters are drawn with numpy over the JAX
modules' shapes, moved by noise and loaded into the port through
``utils/weights.py``; the JAX side runs at HIGHEST matmul precision, its
Deformable-DETR with the Pallas MSDA kernel in interpret mode.

Tolerances: attention maps 1e-6; layers, intermediate dicts and model
outputs 1e-4·max(1, max|ref|); detections 1e-5 (boxes, scores), labels
equal; binary masks equal except at pixels whose probability lies within
1e-5 of 0.5; samples equal; resized masks 1e-4, and images 1e-4 of their
largest value (cv2's bilinear weights against torch's differ in their last
bits); AP and PQ equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu.models import panoptic as jpan
from aloception_tpu.models.deformable_detr import DeformableDETR as JaxDETR
from aloception_tpu.models.detr import Detr as JaxDetr
from aloception_tpu_torch.models import panoptic as tpan
from aloception_tpu_torch.models.deformable_detr import DeformableDETR
from aloception_tpu_torch.models.detr import Detr
from aloception_tpu_torch.utils.weights import (
    panoptic_head_state_dict_from_jax, panoptic_state_dict_from_jax)

from torch_parity import close, init_like, perturb, t, with_7x7_stem

D, NH = 64, 4
# eval_on_coco's --tiny detectors, over the synthetic sample's 4 classes
TINY = dict(num_classes=4, hidden_dim=D, num_queries=20, nheads=NH,
            num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
            stage_sizes=(1, 1, 1, 1), return_intermediate=True)
# a 100x132 image: layer1-4 maps of 25x33, 13x17, 7x9 and 4x5
HW = (100, 132)
FEATURE_SIZES = ((4, 5), (7, 9), (13, 17), (25, 33))   # C5 first


def rel_close(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, 1e-4 * max(1.0, float(np.abs(want).max())))


def _head_params(name, params):
    """The port's names of one head module's params, without its prefix:
    the whole head's mapping, the other module's params drawn at small
    widths and dropped."""
    rng = np.random.RandomState(0)
    head = {
        "bbox_attention": init_like(jpan.MHAttentionMap(8, 2), rng,
                                    np.zeros((1, 1, 8), np.float32),
                                    np.zeros((1, 1, 1, 8), np.float32)
                                    )["params"],
        "mask_head": init_like(jpan.MaskHeadSmallConv(16, (8, 8, 8)), rng,
                               np.zeros((1, 2, 2, 18), np.float32),
                               [np.zeros((1, 2, 2, 8), np.float32)] * 3
                               )["params"],
        name: params}
    sd = panoptic_head_state_dict_from_jax(head)
    return {k.split(".", 1)[1]: v for k, v in sd.items()
            if k.startswith(name + ".")}


@pytest.mark.parametrize("padded", [True, False])
def test_mh_attention_map_matches_flax(padded):
    rng = np.random.RandomState(int(padded))
    B, Nq, H, W = 2, 7, 5, 6
    q = rng.randn(B, Nq, D).astype(np.float32)
    k = rng.randn(B, H, W, D).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, H, W), np.float32)
        mask[1, :, 4:] = 1.0
        mask[1, 3:, :] = 1.0
    jm = jpan.MHAttentionMap(D, NH)
    params = perturb(jm.init(jax.random.PRNGKey(0), q, k, mask)["params"],
                     rng)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, q, k, mask))

    port = tpan.MHAttentionMap(D, NH)
    port.load_state_dict(_head_params("bbox_attention", params), strict=True)
    with torch.no_grad():
        got = port(t(q), t(k), None if mask is None else t(mask))
    close(got, want, 1e-6)
    # one softmax over heads and space jointly
    assert np.allclose(got.sum((2, 3, 4)).numpy(), 1.0, atol=1e-5)
    if padded:
        assert float(got[1][..., 3:, :].abs().max()) == 0.0


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_mask_head_matches_flax_at_odd_sizes(layout):
    """Nearest resizes between 4x5, 7x9, 13x17 and 25x33 (no ratio is 2),
    the adapters added to each image's queries b-major."""
    rng = np.random.RandomState(2)
    B, Nq = 2, 3
    fpn_dims = (48, 40, 24)                       # layer3, layer2, layer1
    (h, w), fpn_sizes = FEATURE_SIZES[0], FEATURE_SIZES[1:]
    src = rng.randn(B, h, w, D).astype(np.float32)
    attn = rng.rand(B, Nq, NH, h, w).astype(np.float32)
    fpns = [rng.randn(B, fh, fw, c).astype(np.float32)
            for (fh, fw), c in zip(fpn_sizes, fpn_dims)]
    x = np.concatenate([np.repeat(src, Nq, axis=0),
                        np.moveaxis(attn.reshape(B * Nq, NH, h, w), 1, -1)],
                       -1)
    jm = jpan.MaskHeadSmallConv(D, fpn_dims)
    params = perturb(jm.init(jax.random.PRNGKey(0), x, fpns)["params"], rng)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, x, fpns))

    port = tpan.MaskHeadSmallConv(D + NH, D, fpn_dims)
    port.load_state_dict(_head_params("mask_head", params), strict=True)
    fmt = getattr(torch, {"contiguous": "contiguous_format",
                          "channels_last": "channels_last"}[layout])
    port.to(memory_format=fmt)
    with torch.no_grad():
        got = port(t(src).permute(0, 3, 1, 2).contiguous(memory_format=fmt),
                   t(attn),
                   [t(f).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
                    for f in fpns])
    assert got.shape == (B, Nq) + FEATURE_SIZES[-1]
    rel_close(got, want.reshape(B, Nq, *FEATURE_SIZES[-1]))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, *HW, 3).astype(np.float32)
    mask = np.zeros((2,) + HW, np.float32)
    mask[1, :, 100:] = 1.0
    mask[1, 76:, :] = 1.0
    return images, mask


def panoptic_pair(kind, seed=0):
    """(JAX DetrPanoptic, its params, the port's DetrPanoptic loaded with
    them) over eval_on_coco's tiny ``kind`` detector."""
    rng = np.random.RandomState(seed)
    if kind == "detr":
        jdet, tdet = JaxDetr(**TINY), Detr(**TINY)
    else:
        jdet = JaxDETR(with_box_refine=False, **TINY)
        tdet = DeformableDETR(with_box_refine=False, **TINY)
    jm = jpan.DetrPanoptic(detector=jdet, num_classes=TINY["num_classes"])
    images, mask = _inputs(seed)
    params = perturb(init_like(jm, rng, images[:1], mask[:1])["params"], rng)
    with_7x7_stem(params["detector"]["backbone"], rng)
    port = tpan.DetrPanoptic(tdet.eval(), num_classes=TINY["num_classes"])
    port.load_state_dict(panoptic_state_dict_from_jax(params), strict=True)
    return jm, params, port


@pytest.fixture(scope="module", params=["detr", "deformable"])
def forward_pair(request):
    """Both packages' panoptic forward of the tiny ``kind`` model on a
    padded 100x132 batch."""
    jm, params, port = panoptic_pair(request.param)
    images, mask = _inputs(1)
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jm.apply)({"params": params}, images,
                                                mask))
    with torch.no_grad():
        got = port(t(images), t(mask))
    return request.param, got, want


def test_return_intermediate_matches_flax(forward_pair):
    kind, got, want = forward_pair
    keys = {"dec_outputs", "enc_outputs", "proj_src", "feat_mask"}
    if kind == "deformable":
        keys |= {"enc_outputs_spatial"}
        # the head reads the C5 level: 4x5 at 100x132
        assert got["enc_outputs_spatial"].shape[1:3] == FEATURE_SIZES[0]
    # the JAX Deformable-DETR's srcs_masks and spatial_shapes, which nothing
    # reads, are not ported
    assert set(got) == set(want) - {"srcs_masks", "spatial_shapes"}
    for k in keys:
        rel_close(got[k], want[k])
    assert len(got["bb_outputs"]) == len(want["bb_outputs"]) == 3
    for g, w, size in zip(got["bb_outputs"], want["bb_outputs"],
                          FEATURE_SIZES[:0:-1]):
        assert g.shape[1:3] == size
        rel_close(g, w)
    for g, w in zip(got["bb_masks"], want["bb_masks"]):
        rel_close(g, w)


def test_detr_panoptic_matches_flax(forward_pair):
    _, got, want = forward_pair
    assert got["pred_masks"].shape == (2, TINY["num_queries"]) \
        + FEATURE_SIZES[-1]
    for k in ("pred_masks", "pred_logits", "pred_boxes"):
        rel_close(got[k], want[k])


def fake_outputs(seed, activation):
    rng = np.random.RandomState(seed)
    n_logits = 5 if activation == "softmax" else 4
    return {"pred_logits": (2 * rng.randn(3, 20, n_logits)).astype(
                np.float32),
            "pred_boxes": rng.uniform(0, 1, (3, 20, 4)).astype(np.float32),
            "pred_masks": (3 * rng.randn(3, 20, 12, 17)).astype(np.float32)}


def same_masked_detections(got, want, probs=None):
    """Per image: boxes, labels and scores, and binary masks equal except at
    pixels where ``probs`` (the upsampled probabilities, kept queries
    only) is within 1e-5 of 0.5."""
    assert len(got) == len(want)
    offset = 0
    for (gb, gm), (wb, wm) in zip(got, want):
        assert isinstance(gb, tsc.BoundingBoxes2D) and isinstance(gm, tsc.Mask)
        assert (gb.boxes_format, gb.absolute) == ("xcyc", False)
        assert gm.names == ("N", "H", "W") and gm.dtype == torch.float32
        assert gb.shape == wb.shape
        for labels in (gb.labels, gm.labels):
            assert np.array_equal(labels.array.numpy(),
                                  wb.get_child("labels").as_numpy())
        if len(gb):
            close(gb.array, wb.as_numpy(), 1e-5)
            for labels in (gb.labels, gm.labels):
                close(labels.scores, wb.get_child("labels").scores, 1e-5)
        assert gm.shape == wm.shape
        differ = gm.array.numpy() != wm.as_numpy()
        if probs is not None:
            near = np.abs(probs[offset:offset + len(gm)] - 0.5) < 1e-5
            differ &= ~near
        assert not differ.any()
        offset += len(gm)


@pytest.mark.parametrize("activation,frame_size,threshold", [
    ("softmax", (50, 70), 0.0), ("softmax", None, 0.5),
    ("sigmoid", (50, 70), 0.2), ("sigmoid", (12, 17), 0.5),
    ("softmax", (50, 70), 1.1)], ids=["softmax-upsampled", "softmax-stride4",
                                      "sigmoid-upsampled", "sigmoid-same-size",
                                      "nothing-kept"])
def test_inference_with_masks_matches_jax(activation, frame_size, threshold):
    out = fake_outputs(len(str(frame_size)) + int(10 * threshold), activation)
    kw = dict(threshold=threshold, activation_fn=activation,
              frame_size=frame_size,
              background_class=4 if activation == "softmax" else None)
    want = jpan.inference_with_masks(out, **kw)
    got = tpan.inference_with_masks({k: t(v) for k, v in out.items()}, **kw)
    n_kept = sum(len(b) for b, _ in got)
    if threshold > 1:
        assert n_kept == 0
        for _, m in got:
            assert m.shape == (0,) + frame_size
    else:
        assert n_kept > 0
    # the kept queries' probabilities as the port upsamples them
    probs = None
    if frame_size is not None and n_kept:
        logits = np.concatenate([out["pred_masks"][b][
            np.isin(np.arange(20), _kept(out, b, kw))] for b in range(3)])
        probs = torch.nn.functional.interpolate(
            torch.sigmoid(t(logits))[None], size=frame_size, mode="bilinear",
            align_corners=False)[0].numpy()
    same_masked_detections(got, want, probs)


def _kept(out, b, kw):
    logits = out["pred_logits"][b]
    if kw["activation_fn"] == "softmax":
        e = np.exp(logits - logits.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True)
        keep = (p.argmax(-1) != kw["background_class"]) & \
            (p.max(-1) > kw["threshold"])
    else:
        keep = (1 / (1 + np.exp(-logits))).max(-1) > kw["threshold"]
    return np.nonzero(keep)[0]


# ----------------------------------------------------------------------
# the samples and the masks' transforms
# ----------------------------------------------------------------------
def same_frame(got, want, atol=0.0):
    """Payload (to atol relative to its largest value), boxes, masks (to
    atol) and their labels."""
    image = want.as_numpy()
    close(got.array, image, atol * max(1.0, float(np.abs(image).max())))
    for name in ("boxes2d", "segmentation"):
        g, w = got.get_child(name), want.get_child(name)
        close(g.array, w.as_numpy(), atol if name == "segmentation" else 0.0)
        gl, wl = g.get_child("labels"), w.get_child("labels")
        assert np.array_equal(gl.array.numpy(), wl.as_numpy())
        assert tuple(gl.labels_names) == tuple(wl.labels_names)


@pytest.mark.parametrize("idx", [0, 3, 6, 9])
def test_masked_coco_sample_matches_jax(idx):
    from aloception_tpu.alodataset.coco_detection import (
        CocoBaseDataset as JaxCoco)
    from aloception_tpu_torch.alodataset import CocoBaseDataset
    want = JaxCoco(sample=True, return_masks=True).getitem(idx)
    got = CocoBaseDataset(sample=True, return_masks=True).getitem(idx)
    seg = got.segmentation
    assert seg.names == ("N", "H", "W") and len(seg) == len(got.boxes2d)
    same_frame(got, want)


@pytest.mark.parametrize("idx", [0, 4, 7])
def test_coco_panoptic_sample_matches_jax(idx):
    from aloception_tpu.alodataset import coco_panoptic as jcp
    from aloception_tpu_torch.alodataset import coco_panoptic as tcp
    jds = jcp.CocoPanopticDataset(sample=True)
    tds = tcp.CocoPanopticDataset(sample=True)
    assert tds.isthing == jds.isthing and len(tds) == len(jds)
    same_frame(tds.getitem(idx), jds.getitem(idx))
    ids = np.random.RandomState(idx).randint(0, 2**24, (5, 7))
    assert np.array_equal(tcp.id2rgb(ids), jcp.id2rgb(ids))
    assert np.array_equal(tcp.rgb2id(tcp.id2rgb(ids)), ids)


def test_mask_transforms_and_batch_match_jax():
    """hflip and a bilinear resize carry the segmentation child as the JAX
    package does (soft edges after the resize); batch_list pads it and
    keeps a per-frame list."""
    from aloception_tpu.alodataset.coco_detection import (
        CocoBaseDataset as JaxCoco)
    from aloception_tpu_torch.alodataset import CocoBaseDataset
    jds, tds = JaxCoco(sample=True, return_masks=True), \
        CocoBaseDataset(sample=True, return_masks=True)
    jf, tf = [], []
    for idx, size in ((1, (90, 110)), (2, (301, 409))):
        jf.append(jds.getitem(idx).hflip().resize(size))
        tf.append(tds.getitem(idx).hflip().resize(size))
        same_frame(tf[-1], jf[-1], 1e-4)
    seg = tf[-1].segmentation.array
    assert bool(((seg > 0) & (seg < 1)).any())
    jb, tb = jsc.batch_list(jf), tsc.batch_list(tf)
    assert isinstance(tb.segmentation, list) and len(tb.segmentation) == 2
    for g, w in zip(tb.segmentation, jb.get_child("segmentation")):
        assert g.shape == (len(g),) + tuple(tb.HW)
        close(g.array, w.as_numpy(), 1e-4)


def test_data_module_val_batch_matches_jax():
    from aloception_tpu.train import CocoDetection2Detr as JaxDM
    from aloception_tpu_torch.train import CocoDetection2Detr
    kw = dict(batch_size=2, sample=True, size=(96, 128), return_masks=True)
    jdm, tdm = JaxDM(**kw), CocoDetection2Detr(**kw)
    jb = jdm.prepare_batch(next(iter(jdm.val_dataloader())), training=False)
    tb = tdm.prepare_batch(next(iter(tdm.val_dataloader())), training=False)
    for g, w in zip(tb["inputs"], jb["inputs"]):
        close(g, w, 1e-4)
    segs = tb["frames"].segmentation
    for g, w in zip(segs, jb["frames"].get_child("segmentation")):
        close(g.array, w.as_numpy(), 1e-4)
        assert np.array_equal(g.labels.array.numpy(),
                              w.get_child("labels").as_numpy())


# ----------------------------------------------------------------------
# the slice as a whole: both packages' eval_on_coco loops
# ----------------------------------------------------------------------
def _recorded(monkeypatch, metrics_module, calls):
    """Record each (instance, pred, gt) that the eval loop adds to the
    ApMetrics and PQMetrics of ``metrics_module``."""
    for name in ("ApMetrics", "PQMetrics"):
        cls = getattr(metrics_module, name)
        add = cls.add_sample

        def recording(self, pred, gt, *a, _add=add, _name=name, **k):
            calls.append((_name, self, pred, gt))
            return _add(self, pred, gt, *a, **k)
        monkeypatch.setattr(cls, "add_sample", recording)


@pytest.mark.parametrize("model", ["panoptic", "panoptic_deformable"])
def test_eval_loop_matches_jax(model, monkeypatch, tmp_path):
    """The same tiny weights (the JAX init patched to return them; the port
    reading them through --weights) and the same sample batches through
    both packages' eval_on_coco: equal per-frame detections and masks,
    equal AP and PQ."""
    import aloception_tpu.metrics as jmetrics
    import aloception_tpu_torch.metrics as tmetrics
    from aloception_tpu.commands import eval_on_coco as jeval
    from aloception_tpu_torch.commands import eval_on_coco as teval

    _, params, _ = panoptic_pair("detr" if model == "panoptic"
                                 else "deformable", seed=5)
    monkeypatch.setattr(jpan.DetrPanoptic, "init",
                        lambda self, *a, **k: {"params": params})
    weights = tmp_path / "panoptic.pth"
    torch.save(panoptic_state_dict_from_jax(params), weights)
    argv = ["--cpu", "--sample", "--tiny", "--model", model,
            "--limit_batches", "2", "--size", "96", "128"]
    jcalls, tcalls = [], []
    _recorded(monkeypatch, jmetrics, jcalls)
    _recorded(monkeypatch, tmetrics, tcalls)
    with jax.default_matmul_precision("highest"):
        want = jeval.main(argv)
    got = teval.main(argv + ["--weights", str(weights)])

    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert len(tcalls) == 8          # 2 batches of 2 frames, AP and PQ
    n_kept = 0
    for (name, _, tp, tg), (_, _, jp, jg) in zip(tcalls, jcalls):
        close(tg.array, jg.as_numpy(), 1e-5)
        if name == "ApMetrics":
            close(tp.array, jp.as_numpy(), 1e-5)
            close(tp.labels.scores, jp.get_child("labels").scores, 1e-5)
            n_kept += len(tp)
        else:
            assert tp.shape == jp.shape and tp.shape[1:] == (96, 128)
            assert np.array_equal(tp.array.numpy(), jp.as_numpy())
        assert np.array_equal(tp.labels.array.numpy(),
                              jp.get_child("labels").as_numpy())
    assert n_kept > 0
    assert got == want
    tpq = next(c[1] for c in tcalls if c[0] == "PQMetrics")
    jpq = next(c[1] for c in jcalls if c[0] == "PQMetrics")
    for isthing in (None, True, False):
        assert tpq.pq_average(isthing) == jpq.pq_average(isthing)


@pytest.mark.parametrize("model", ["detr", "deformable", "panoptic",
                                   "panoptic_deformable"])
def test_eval_on_coco_cli(model, capsys):
    from aloception_tpu_torch.commands import eval_on_coco
    maps = eval_on_coco.main(["--cpu", "--sample", "--tiny", "--model", model,
                              "--limit_batches", "1", "--size", "96", "128"])
    out = capsys.readouterr().out
    assert 0.0 <= maps["all"]["all"] <= 100.0
    assert "[eval_on_coco] AP=" in out
    assert ("[eval_on_coco] PQ=" in out) == model.startswith("panoptic")


def test_eval_on_coco_runs_on_the_card_or_raises():
    """Without --cpu the command runs on the CUDA card; without a card it
    raises and points at the CPU."""
    from aloception_tpu_torch.commands import eval_on_coco
    argv = ["--sample", "--tiny", "--model", "panoptic", "--limit_batches",
            "1", "--size", "96", "128"]
    if torch.cuda.is_available():
        assert eval_on_coco.main(argv)["all"]["all"] >= 0.0
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            eval_on_coco.main(argv)


def test_detr_panoptic_builds_on_the_card_or_raises():
    """With no detector and no device DetrPanoptic builds DETR-R50 on the
    CUDA card; without a card it raises and points at device="cpu"."""
    if torch.cuda.is_available():
        model = tpan.DetrPanoptic()
        assert {p.device.type for p in model.parameters()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpan.DetrPanoptic()
    with pytest.raises(ValueError, match="return_intermediate"):
        tpan.DetrPanoptic(Detr(**{**TINY, "return_intermediate": False}))
