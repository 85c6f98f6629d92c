"""aloscene of the PyTorch port against the JAX package's, on the CPU: the
semantic tests of ``test_frame.py``, ``test_boxes.py`` and
``test_augmented.py`` that touch Frame, BoundingBoxes2D, Labels and Mask,
replayed on the same numpy inputs through both packages, comparing payloads,
names, properties and children (``Labels.scores`` included).

Tolerances: 1e-6 absolute on data in [0, 1] and on boxes; one float32 ulp
relative (2**-23 of the magnitude) on 0-255 frame data, where an element-wise
op of both packages rounds once; 1e-3 for the bilinear resize against the
JAX package's cv2 path on 0-255 data (bilinear weights differ in the last
bits between the two implementations)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu.ops import boxes as jbox
from aloception_tpu_torch.ops import boxes as tbox

from torch_parity import close

ULP = 2.0 ** -23
BOXES = np.array([[0.5, 0.5, 0.2, 0.2],
                  [0.3, 0.7, 0.1, 0.4],
                  [0.8, 0.2, 0.2, 0.2]], np.float32)


def same(got, want, rtol=ULP, atol=1e-6):
    """A port object against the JAX one: type, dim names, properties,
    payload, scores and children, recursively. Payloads within
    atol + rtol * max|want|."""
    if want is None or isinstance(want, (dict, list)):
        assert type(got) is type(want), (got, want)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                same(got[k], want[k], rtol, atol)
        elif isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                same(g, w, rtol, atol)
        return
    assert type(got).__name__ == type(want).__name__
    assert got.names == want.names
    assert got._properties == want._properties
    w = np.asarray(want.as_numpy(), np.float32)
    close(got.array, w, atol + rtol * float(np.abs(w).max(initial=0.0)))
    if isinstance(want, jsc.Labels):
        assert (got.scores is None) == (want.scores is None)
        if want.scores is not None:
            close(got.scores, want.scores, atol)
    assert got._children.keys() == want._children.keys()
    for k in want._children:
        same(got._children[k], want._children[k], rtol, atol)


def frames(h=32, w=40, normalization="255", seed=0):
    """The same 0-255 CHW float32 image as a JAX Frame and a port Frame."""
    x = np.random.RandomState(seed).uniform(0, 255, (3, h, w)).astype(
        np.float32)
    return (jsc.Frame(x, normalization=normalization),
            tsc.Frame(torch.from_numpy(x), normalization=normalization))


def boxes(pkg, data=BOXES, fmt="xcyc", absolute=False, frame_size=None,
          labels=True):
    lab = None
    if labels:
        n = len(data)
        lab = pkg.Labels(np.arange(1, n + 1, dtype=np.float32),
                         scores=np.linspace(0.9, 0.5, n).astype(np.float32))
    return pkg.BoundingBoxes2D(data, boxes_format=fmt, absolute=absolute,
                               frame_size=frame_size, labels=lab)


def with_boxes(pair, data=BOXES):
    jf, tf = pair
    jf.append_boxes2d(boxes(jsc, data))
    tf.append_boxes2d(boxes(tsc, data))
    return jf, tf


# ----------------------------------------------------------------------
# Frame: normalization, padding, geometry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("convert", ["norm01", "norm255", "norm_minmax_sym",
                                     "norm_resnet"])
def test_norm_roundtrip(convert):
    jf, tf = frames()
    jc, tc = getattr(jf, convert)(), getattr(tf, convert)()
    same(tc, jc)
    same(tc.norm255(), jc.norm255())
    assert tc.norm255().normalization == "255"


def test_norm_state_and_norm_as():
    jf, tf = frames()
    same(tf.norm_resnet().norm01(), jf.norm_resnet().norm01())
    assert tf.norm_resnet().norm01().mean_std is None
    jt, tt = frames(seed=1)
    same(tf.norm_as(tt.norm_resnet()), jf.norm_as(jt.norm_resnet()))
    same(tf.norm_resnet().norm_minmax_sym(), jf.norm_resnet().norm_minmax_sym())


@pytest.mark.parametrize("norm", ["norm_resnet", "norm_minmax_sym", "norm01"])
def test_pad_fill_values(norm):
    """Padded pixels hold normalised black: (0 - mean) / std for resnet,
    -1 for minmax_sym, 0 for 01."""
    jf, tf = frames()
    jp = getattr(jf, norm)().pad((0.0, 0.25), (0.1, 0.25))
    tp = getattr(tf, norm)().pad((0.0, 0.25), (0.1, 0.25))
    assert tp.shape == (3, 40, 54)
    same(tp, jp)


def test_pad_multiple():
    jf, tf = frames(30, 41)
    same(tf.pad(multiple=8), jf.pad(multiple=8))
    assert tf.pad(multiple=8).HW == (32, 48)


@pytest.mark.parametrize("pad_boxes", [False, True])
def test_pad_boxes_semantics(pad_boxes):
    """Default pad keeps boxes unmoved and records padded_size, twice in a
    row; fit_to_padded_size (or pad_boxes=True) moves them."""
    jf, tf = with_boxes(frames(32, 40))
    jp = jf.pad((0.0, 1.0), (0.5, 1.0), pad_boxes=pad_boxes)
    tp = tf.pad((0.0, 1.0), (0.5, 1.0), pad_boxes=pad_boxes)
    same(tp, jp)
    if not pad_boxes:
        jp, tp = jp.pad((4, 0), (0, 6)), tp.pad((4, 0), (0, 6))
        same(tp, jp)
        same(tp.boxes2d.fit_to_padded_size(), jp.boxes2d.fit_to_padded_size())
        same(tp.boxes2d.remove_padding(), jp.boxes2d.remove_padding())


def test_crop_filters_children():
    jf, tf = with_boxes(frames(32, 40), np.concatenate(
        [BOXES, [[0.05, 0.05, 0.05, 0.05]]]).astype(np.float32))
    jc, tc = jf.crop((0.25, 0.75), (0.25, 0.75)), tf.crop((0.25, 0.75),
                                                          (0.25, 0.75))
    same(tc, jc)
    assert tc.boxes2d.shape[0] == 3          # the corner box fell outside
    # absolute boxes: cropped in pixels of the frame
    jb = boxes(jsc, fmt="xcyc").abs_pos((32, 40))
    tb = boxes(tsc, fmt="xcyc").abs_pos((32, 40))
    same(tb._crop((0.1, 0.6), (0.3, 0.9)), jb._crop((0.1, 0.6), (0.3, 0.9)))


@pytest.mark.parametrize("flip", ["hflip", "vflip"])
def test_flip_frame_and_boxes(flip):
    jf, tf = with_boxes(frames())
    same(getattr(tf, flip)(), getattr(jf, flip)())
    jb = boxes(jsc, fmt="xyxy").abs_pos((100, 200))
    tb = boxes(tsc, fmt="xyxy").abs_pos((100, 200))
    same(getattr(tb, flip)(), getattr(jb, flip)(), rtol=4 * ULP)


@pytest.mark.parametrize("shift", [(0.25, 0.0), (-0.1, 0.3)])
def test_spatial_shift(shift):
    """Frames roll and fill the uncovered band with the channel mean (a
    float32 reduction: summation order differs, so 1e-4 on 0-255 data);
    boxes move, are clipped and the empty ones dropped."""
    jf, tf = frames()
    close(tf.spatial_shift(*shift).array, jf.spatial_shift(*shift).as_numpy(),
          1e-4)
    same(boxes(tsc).spatial_shift(*shift), boxes(jsc).spatial_shift(*shift))


def test_spatial_shift_uint8():
    """An integer frame's band takes its channel mean truncated to the
    payload's dtype; no mean sits within reach of an integer here."""
    x = np.random.RandomState(2).randint(0, 256, (3, 16, 20)).astype(np.uint8)
    means = x.reshape(3, -1).mean(1)
    assert np.abs(means - np.round(means)).min() > 1e-3
    got = tsc.Frame(torch.from_numpy(x)).spatial_shift(0.25, -0.1).array
    want = jsc.Frame(x).spatial_shift(0.25, -0.1).as_numpy()
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 40), (45, 71)),       # up by non-integer ratios
    ((45, 71), (32, 40)),       # down by non-integer ratios
    ((30, 40), (17, 64)),       # down in H, up in W
])
def test_resize_matches_cv2_path(in_hw, out_hw):
    """Bilinear, half-pixel centres, no antialias: the JAX package's cv2
    INTER_LINEAR path for host frames. Absolute boxes scale with it."""
    jf, tf = frames(*in_hw)
    jf.append_boxes2d(boxes(jsc).abs_pos(in_hw))
    tf.append_boxes2d(boxes(tsc).abs_pos(in_hw))
    jr, tr = jf.resize(out_hw), tf.resize(out_hw)
    assert tr.HW == out_hw
    same(tr.boxes2d, jr.boxes2d, rtol=4 * ULP)
    close(tr.array, jr.as_numpy(), 1e-3)


# ----------------------------------------------------------------------
# containers: batching, indexing, dims, arithmetic, devices
# ----------------------------------------------------------------------
def two_frames(labels=False):
    f1 = with_boxes(frames(32, 40))
    f2 = with_boxes(frames(24, 36, seed=1), BOXES[:2])
    if labels:     # frame-level labels, as many on each frame
        for i, (jf, tf) in enumerate((f1, f2)):
            ids = np.array([i, 5.0], np.float32)
            jf.append_labels(jsc.Labels(ids, scores=ids / 10))
            tf.append_labels(tsc.Labels(ids, scores=ids / 10))
    return f1, f2


@pytest.mark.parametrize("kwargs", [{}, {"size": (40, 48)},
                                    {"pad_boxes": True}])
def test_batch_list_mask_and_children(kwargs):
    (j1, t1), (j2, t2) = two_frames()
    jb = jsc.batch_list([j1.norm_resnet(), j2.norm_resnet()], **kwargs)
    tb = tsc.batch_list([t1.norm_resnet(), t2.norm_resnet()], **kwargs)
    same(tb, jb)
    assert tb.names == ("B", "C", "H", "W")
    assert isinstance(tb.boxes2d, list) and len(tb.boxes2d) == 2
    assert float(tb.mask.array[0].sum()) == (tb.H * tb.W - 32 * 40)


def test_batch_list_intersection_and_merged_labels():
    """Frame labels are mergeable: ids (and, in the port, their scores) gain
    the B dim and are concatenated. A child missing on one frame raises
    unless intersection=True drops it."""
    (j1, t1), (j2, t2) = two_frames(labels=True)
    tb = tsc.batch_list([t1, t2])
    jb = jsc.batch_list([j1, j2])
    assert tb.labels.names == ("B", "N")
    close(tb.labels.array, jb.labels.as_numpy(), 0.0)
    close(tb.labels.scores, jb.labels.as_numpy() / 10, 0.0)
    same(tb[1].labels, j2.labels)
    t3 = tsc.Frame(torch.zeros(3, 32, 40))
    with pytest.raises(ValueError):
        tsc.batch_list([t1, t3])
    assert tsc.batch_list([t1, t3], intersection=True).labels is None


def test_getitem_batch_crop_and_filter():
    (j1, t1), (j2, t2) = two_frames()
    jb, tb = jsc.batch_list([j1, j2]), tsc.batch_list([t1, t2])
    same(tb[1], jb[1])
    assert tb[0].names == ("C", "H", "W")
    # H/W slicing crops the children
    same(t1[:, 8:24, 10:30], j1[:, 8:24, 10:30])
    same(tb[0:1], jb[0:1])
    # a bool mask filters boxes with their labels and scores
    keep = np.array([True, False, True])
    same(t1.boxes2d[keep], j1.boxes2d[keep])
    same(t1.boxes2d[torch.from_numpy(keep)], j1.boxes2d[keep])


def test_temporal_batch_dims_and_temporal_list():
    jf, tf = with_boxes(frames())
    same(tf.temporal().batch(), jf.temporal().batch())
    assert tf.temporal().batch().names == ("B", "T", "C", "H", "W")
    j2, t2 = frames(seed=1)
    same(tsc.temporal_list([tf.batch(), t2.batch()]),
         jsc.temporal_list([jf.batch(), j2.batch()]))


def test_arithmetic_keeps_metadata():
    jf, tf = with_boxes(frames())
    for op in (lambda f: f / 2.0, lambda f: 1.0 - f, lambda f: f * f,
               lambda f: -f + 3.0):
        same(op(tf), op(jf))


def test_to_cpu_clone_keep_children_properties_and_scores():
    """The port's counterpart of the JAX pytree round trip: ``.to()``,
    ``.cpu()`` and ``clone()`` rebuild the whole structure."""
    jf, tf = with_boxes(frames())
    tf.append_labels(tsc.Labels([2.0], scores=[0.25]))
    tf = tf.norm_resnet()
    for moved in (tf.to("cpu"), tf.cpu(), tf.clone()):
        assert isinstance(moved.boxes2d.labels, tsc.Labels)
        assert moved.boxes2d is not tf.boxes2d
        same(moved.boxes2d, jf.boxes2d)
        assert moved.normalization == "resnet"
        close(moved.labels.scores, [0.25], 0.0)
    half = tf.to(dtype=torch.bfloat16)
    assert half.dtype == half.boxes2d.dtype == torch.bfloat16
    assert half.boxes2d.labels.scores.dtype == torch.bfloat16
    clone = tf.clone()
    clone.array.zero_()
    assert float(tf.array.abs().sum()) > 0       # payload copied


def test_as_image():
    jf, tf = frames()
    img = tf.norm_resnet().as_image()
    assert img.shape == (32, 40, 3) and img.dtype == torch.uint8
    want = jf.norm_resnet().as_image()
    # float32 round trip through the resnet norm, then truncation
    assert np.abs(img.numpy().astype(int) - want.astype(int)).max() <= 1


# ----------------------------------------------------------------------
# boxes and masks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("path", [("xyxy", "xcyc"), ("yxyx", "xcyc"),
                                  ("xyxy", "yxyx")])
def test_box_format_roundtrip(path):
    jb, tb = boxes(jsc), boxes(tsc)
    for fmt in path + ("xcyc",):
        jb, tb = jb.get_with_format(fmt), tb.get_with_format(fmt)
        same(tb, jb)


def test_abs_rel_roundtrip_and_area():
    jb, tb = boxes(jsc), boxes(tsc)
    same(tb.abs_pos((100, 200)), jb.abs_pos((100, 200)))
    same(tb.abs_pos((100, 200)).rel_pos(), jb.abs_pos((100, 200)).rel_pos())
    same(tb.abs_pos((100, 200)).abs_pos((50, 100)),
         jb.abs_pos((100, 200)).abs_pos((50, 100)), rtol=4 * ULP)
    same(tb.yxyx().abs_pos((100, 200)), jb.yxyx().abs_pos((100, 200)))
    close(tb.area(), np.asarray(jb.area()), 1e-6)
    close(tb.abs_area((64, 80)), np.asarray(jb.abs_area((64, 80))), 1e-3)
    close(tb.abs_pos((64, 80)).rel_area(),
          np.asarray(jb.abs_pos((64, 80)).rel_area()), 1e-6)


def test_iou_giou_and_mixed_states():
    rng = np.random.RandomState(0)
    data = np.concatenate([rng.uniform(0.1, 0.6, (6, 2)),
                           rng.uniform(0.05, 0.4, (6, 2))], 1).astype(
                               np.float32)
    jb, tb = boxes(jsc, data), boxes(tsc, data)
    close(tb.iou_with(tb), np.asarray(jb.iou_with(jb)), 1e-6)
    close(tb.giou_with(tb.xyxy()), np.asarray(jb.giou_with(jb.xyxy())), 1e-6)
    close(tb.iou_with(tb.abs_pos((64, 64))),
          np.asarray(jb.iou_with(jb.abs_pos((64, 64)))), 1e-6)
    a, c = data[:3], data[3:] + 0.05
    for fn in ("iou_xyxy", "giou_xyxy", "giou_xyxy_paired"):
        close(getattr(tbox, fn)(tbox.xcyc_to_xyxy(torch.from_numpy(a)),
                                tbox.xcyc_to_xyxy(torch.from_numpy(c))),
              getattr(jbox, fn)(jbox.xcyc_to_xyxy(jnp.asarray(a)),
                                jbox.xcyc_to_xyxy(jnp.asarray(c))), 1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_nms_keeps_the_same_boxes(seed):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 0.6, (24, 2))
    data = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (24, 2))],
                          1).astype(np.float32)
    scores = rng.permutation(24).astype(np.float32) / 24
    jb = jsc.BoundingBoxes2D(data, "xyxy", False)
    tb = tsc.BoundingBoxes2D(data, "xyxy", False)
    want = jb.nms(scores, iou_threshold=0.4)
    got = tb.nms(scores, iou_threshold=0.4)
    assert got.tolist() == want.tolist()
    assert 1 < len(want) < 24


def test_labels_filtered_with_boxes():
    jb, tb = boxes(jsc), boxes(tsc)
    jc, tc = jb._crop((0.4, 1.0), (0.4, 1.0)), tb._crop((0.4, 1.0), (0.4, 1.0))
    same(tc, jc)
    assert tc.shape[0] == tc.labels.shape[0] == len(tc.labels.scores)


def test_as_boxes():
    jb, tb = boxes(jsc), boxes(tsc)
    jt = boxes(jsc, fmt="yxyx").abs_pos((30, 50)).pad((0.0, 0.5), (0.0, 0.5))
    tt = boxes(tsc, fmt="yxyx").abs_pos((30, 50)).pad((0.0, 0.5), (0.0, 0.5))
    same(tb.as_boxes(tt), jb.as_boxes(jt))


def test_mask_iou_and_mask2id():
    m = np.zeros((3, 16, 16), np.float32)
    m[0, :8] = 1
    m[1, 4:12] = 1
    m[2, 10:, 10:] = 0.8
    ids = np.array([7.0, 9.0, 2.0], np.float32)
    jm = jsc.Mask(m, labels=jsc.Labels(ids))
    tm = tsc.Mask(m, labels=tsc.Labels(ids))
    close(tm.iou_with(tm), np.asarray(jm.iou_with(jm)), 1e-6)
    for kwargs in ({}, {"background_id": 0}):
        assert np.array_equal(tm.mask2id(**kwargs).numpy(),
                              jm.mask2id(**kwargs))
    got, cats = tm.mask2id(return_cats=True)
    assert cats.tolist() == [7, 9, 2]
    unlabelled = tsc.Mask(m)
    assert np.array_equal(unlabelled.mask2id().numpy(), jsc.Mask(m).mask2id())
