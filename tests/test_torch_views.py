"""The port's views and renderer against the JAX package's (OpenCV 5 and
matplotlib), on seeded data at 24x32 to 96x128: ``View`` (``add``, ``save``
read back), both grids with and without titles, the module ``render`` and
``render_save``, every type's ``__get_view__``, ``Frame.get_view`` with
every child, ``exclude`` and ``size``, the drawing primitives and the text
on their own, and ``ObjectDetectorCallback`` through the port's event-file
reader.

Tolerances:
- box and 3-D wireframe pixels bit-equal (``cv2.rectangle``/``cv2.line`` of
  thickness 2 reproduced, boxes and edges clipped at and beyond the border
  and behind the camera included), and every pixel outside the text;
- text (OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` with its built-in Rubik
  TrueType face) by where it is drawn: the bounding box of its pixels
  within 1 px of cv2's and the IoU of the touched-pixel sets >= 0.9
  (measured on these strings: bounding boxes equal, IoU >= 0.989, most
  exactly 1);
- masks 1e-6 (the port sums the planes in one float32 product, JAX plane
  by plane in float64: up to 2.4e-7 apart on 10 soft planes at 966x1280,
  measured; cv2's float resize and torch's bilinear differ in the last
  bits); flow bit-equal; depth and disparity within 1e-7 of matplotlib's
  ``nipy_spectral``; grids 5e-6 outside titles (cells resized from another
  size differ from cv2's float resize by up to 3.6e-6, measured: torch's
  bilinear and cv2's compute the same weights in another order).
"""

import cv2
import numpy as np
import pytest
import torch

import aloception_tpu.aloscene as J
import aloception_tpu_torch.aloscene as P
from aloception_tpu.aloscene import renderer as jr
from aloception_tpu_torch.aloscene import renderer as pr
from aloception_tpu_torch.aloscene.renderer import draw

HW = (96, 128)
NAMES = ("person", "car", "bicycle", "dog", "traffic_light")


def rng_frame(rng, hw=HW):
    return rng.uniform(0, 255, (3,) + hw).astype(np.float32)


def text_iou(a, b):
    """IoU of the touched pixels of two text renderings on black, and the
    largest difference of their bounding boxes' sides."""
    ta, tb = a.any(-1), b.any(-1)
    iou = (ta & tb).sum() / max((ta | tb).sum(), 1)
    if not ta.any() and not tb.any():
        return 1.0, 0
    ya, xa = np.nonzero(ta)
    yb, xb = np.nonzero(tb)
    side = max(abs(ya.min() - yb.min()), abs(ya.max() - yb.max()),
               abs(xa.min() - xb.min()), abs(xa.max() - xb.max()))
    return iou, side


# ----------------------------------------------------------------------
# drawing primitives and text
# ----------------------------------------------------------------------
def test_lines_and_rectangles_equal_cv2():
    rng = np.random.RandomState(0)
    for k in range(400):
        h, w = rng.randint(5, 80, 2)
        span = (140, 2000, 10 ** 6, 2 ** 30)[k % 4]
        a = tuple(int(v) for v in rng.randint(-span // 2, span, 2))
        b = tuple(int(v) for v in rng.randint(-span // 2, span, 2))
        th = (2, 3, 4)[k % 3]
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        if k % 2 and span <= 2000:
            cv2.rectangle(want, a, b, color, th)
            draw.rectangle(got, a, b, color, th)
        else:
            cv2.line(want, a, b, color, th)
            draw.line(got, a, b, color, th)
        assert (got == want).all(), (h, w, a, b, th)
    with pytest.raises(ValueError, match="int32"):
        draw.line(got, (0, 0), (2 ** 31, 4), (1, 2, 3))


@pytest.mark.parametrize("hw", [(24, 32), (96, 128), (480, 640),
                                (1080, 1920)])
def test_text_is_drawn_where_cv2_draws_it(hw):
    rng = np.random.RandomState(hw[0])
    strings = [f"{n} {s:.2f}" for n, s in zip(NAMES, rng.uniform(0, 1, 5))]
    strings += ["7", "val/pred_boxes_0", "MOT17-02 t=1"]
    worst = 1.0
    for s in strings:
        x, y = int(rng.randint(-5, hw[1] // 2)), int(rng.randint(0, hw[0]))
        color = tuple(int(v) for v in rng.randint(1, 256, 3))
        want = np.zeros(hw + (3,), np.uint8)
        got = want.copy()
        jr.put_adaptive_cv2_text(want, s, x, y, color)
        pr.put_adaptive_cv2_text(got, s, x, y, color)
        iou, side = text_iou(got, want)
        assert side <= 1 and iou >= 0.9, (s, iou, side)
        worst = min(worst, iou)
    assert worst >= 0.9


def test_text_on_float_frames_round_trips_as_jax():
    rng = np.random.RandomState(1)
    f = rng.uniform(0, 1, (40, 60, 3)).astype(np.float32)
    a, b = f.copy(), f.copy()
    jr.put_adaptive_cv2_text(a, "dog 0.50", 3, 20)
    pr.put_adaptive_cv2_text(b, "dog 0.50", 3, 20)
    untouched = (a == (np.clip(f, 0, 1) * 255).astype(np.uint8) / 255.0
                 ).all(-1)
    assert (a[untouched] == b[untouched]).all()


# ----------------------------------------------------------------------
# View and Renderer
# ----------------------------------------------------------------------
def test_view_add_and_save(tmp_path):
    rng = np.random.RandomState(2)
    a, b = rng.uniform(0, 1, (20, 30, 3)), rng.uniform(0, 255, (12, 10))
    got = pr.View(a, "a").add(pr.View(b))
    want = jr.View(a, "a").add(jr.View(b))
    assert got.image.dtype == np.float32 and (got.image == want.image).all()
    pa = got.save(str(tmp_path / "p"))
    pj = want.save(str(tmp_path / "j"))
    assert pa.endswith(".png")
    assert (cv2.imread(pa) == cv2.imread(pj)).all()


@pytest.mark.parametrize("add_title", [True, False])
@pytest.mark.parametrize("resize", [False, True])
def test_grids_equal_jax(add_title, resize):
    rng = np.random.RandomState(3)
    hw = (30, 40)
    views = [(rng.uniform(0, 1, (hw if not resize or i == 0 else (23, 51))
                          + (3,)), f"v{i}") for i in range(5)]
    pv = [pr.View(im, t) for im, t in views]
    jv = [jr.View(im, t) for im, t in views]
    for got, want in (
            (pr.Renderer.get_grid_view(pv, add_title=add_title),
             jr.Renderer.get_grid_view(jv, add_title=add_title)),
            (pr.Renderer.get_user_defined_grid_view(
                [pv[:2], pv[2:]], add_title=add_title),
             jr.Renderer.get_user_defined_grid_view(
                [jv[:2], jv[2:]], add_title=add_title))):
        assert got.shape == want.shape
        bh = max(18, hw[0] // 12) if add_title else 0
        rows = np.arange(got.shape[0]) % (hw[0] + bh) >= bh
        np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=5e-6)
        if add_title:   # the banners: the text where cv2 draws it
            banner = ~rows
            iou, side = text_iou(
                (got[banner] * 255).astype(np.uint8) != 38,
                (want[banner] * 255).astype(np.uint8) != 38)
            assert iou >= 0.9 and side <= 1


def test_module_render_and_save():
    rng = np.random.RandomState(4)
    views = [pr.View(rng.uniform(0, 1, (20, 30, 3)), "a")]
    grid = pr.render(views, skip_views=True)
    want = jr.render([jr.View(views[0].image, "a")], skip_views=True)
    assert grid.shape == want.shape
    assert pr.render_save() is None
    with pytest.raises(RuntimeError, match="mp4"):
        pr.render(views, record_file="out.mp4")
    with pytest.raises(RuntimeError, match="window"):
        pr.render(views)
    with pytest.raises(RuntimeError, match="window"):
        views[0].render()
    pr.render_save()


# ----------------------------------------------------------------------
# the types' views
# ----------------------------------------------------------------------
def boxes2d(pkg, rng_seed=5, n=8, labels=True, fmt="xyxy"):
    rng = np.random.RandomState(rng_seed)
    H, W = HW
    xy = np.stack([rng.uniform(-30, W + 30, n), rng.uniform(-30, H + 30, n),
                   rng.uniform(-30, W + 30, n), rng.uniform(-30, H + 30, n)],
                  1)
    b = np.concatenate([np.minimum(xy[:, :2], xy[:, 2:]),
                        np.maximum(xy[:, :2], xy[:, 2:])], 1
                       ).astype(np.float32)
    lab = None
    if labels:
        lab = pkg.Labels(conv(pkg, rng.randint(0, 7, n).astype(np.float32)),
                         labels_names=NAMES,
                         scores=conv(pkg, rng.uniform(0, 1, n)
                                     .astype(np.float32)))
    out = pkg.BoundingBoxes2D(conv(pkg, b), "xyxy", True, frame_size=HW,
                              labels=lab)
    return out.rel_pos().xcyc() if fmt == "xcyc" else out


def conv(pkg, a):
    return torch.from_numpy(np.ascontiguousarray(a)) if pkg is P else a


def text_regions(boxes_np, names, scores):
    """Where the boxes' label texts are drawn, as a mask (text alone, on
    black, by cv2)."""
    img = np.zeros(HW + (3,), np.uint8)
    for (x1, y1, _, _), name, s in zip(boxes_np, names, scores):
        jr.put_adaptive_cv2_text(img, f"{name} {s:.2f}", x1, max(y1 - 3, 10),
                                 (255, 255, 255))
    m = img.any(-1)
    return cv2.dilate(m.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0


@pytest.mark.parametrize("fmt", ["xyxy", "xcyc"])
def test_boxes_view_equals_jax(fmt):
    rng = np.random.RandomState(6)
    frame = rng.uniform(0, 1, HW + (3,)).astype(np.float32)
    plain = [boxes2d(pkg, labels=False, fmt=fmt).get_view(frame=frame).image
             for pkg in (P, J)]
    assert (plain[0] == plain[1]).all()
    got = boxes2d(P, fmt=fmt).get_view(frame=frame).image
    want = boxes2d(J, fmt=fmt).get_view(frame=frame).image
    jb = boxes2d(J, fmt=fmt).abs_pos(HW).xyxy()
    lab = np.asarray(jb.labels.as_numpy()).astype(int)
    txt = text_regions(np.asarray(jb.as_numpy()),
                       [NAMES[i] if i < len(NAMES) else str(i) for i in lab],
                       np.asarray(jb.labels.scores))
    assert txt.any() and (got[~txt] == want[~txt]).all()
    # the default frame of relative boxes, and of labels sets
    b = [boxes2d(pkg, labels=False, fmt="xcyc") for pkg in (P, J)]
    assert (b[0].get_view().image == b[1].get_view().image).all()


def boxes3d(pkg, with_labels):
    rng = np.random.RandomState(7)
    n = 6
    b = np.stack([rng.uniform(-8, 8, n), rng.uniform(-1, 2, n),
                  rng.uniform(-3, 25, n), rng.uniform(1, 4, n),
                  rng.uniform(1, 2, n), rng.uniform(2, 5, n),
                  rng.uniform(-3.1, 3.1, n)], 1).astype(np.float32)
    b[0, 2] = -2.0                     # behind the camera
    b[1, :3] = (60.0, 0.5, 8.0)        # far beside it
    lab = pkg.Labels(conv(pkg, rng.randint(0, 9, n).astype(np.float32))) \
        if with_labels else None
    return pkg.BoundingBoxes3D(conv(pkg, b), labels=lab)


def intrinsic(pkg):
    return pkg.CameraIntrinsic(focal_length=70.0, plane_size=HW)


@pytest.mark.parametrize("with_labels", [True, False])
def test_boxes3d_view_equals_jax(with_labels):
    rng = np.random.RandomState(8)
    frame = rng.uniform(0, 1, HW + (3,)).astype(np.float32)
    got = boxes3d(P, with_labels).get_view(frame=frame,
                                           cam_intrinsic=intrinsic(P))
    want = boxes3d(J, with_labels).get_view(frame=frame,
                                            cam_intrinsic=intrinsic(J))
    assert (got.image == want.image).all()
    assert (got.image != (frame * 255).astype(np.uint8) / 255.0).any()
    assert boxes3d(P, with_labels).get_view() is None


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("on_frame", [None, HW, (48, 64)])
def test_mask_view_equals_jax(labels, on_frame):
    rng = np.random.RandomState(9)
    m = (rng.uniform(0, 1, (4,) + HW) > 0.6).astype(np.float32)
    lab = rng.randint(0, 20, 4).astype(np.float32)
    frame = None if on_frame is None else \
        rng.uniform(0, 1, tuple(on_frame) + (3,)).astype(np.float32)
    views = []
    for pkg in (P, J):
        mask = pkg.Mask(conv(pkg, m), labels=pkg.Labels(conv(pkg, lab))
                        if labels else None)
        views.append(mask.__get_view__(frame=frame).image)
    np.testing.assert_allclose(views[0], views[1], rtol=0, atol=1e-6)


def test_soft_mask_view_equals_jax():
    """Ten soft, overlapping planes: the float32 product against JAX's
    float64 sum plane by plane."""
    rng = np.random.RandomState(12)
    m = rng.uniform(0, 0.3, (10,) + HW).astype(np.float32)
    lab = rng.randint(0, 300, 10).astype(np.float32)
    frame = rng.uniform(0, 1, HW + (3,)).astype(np.float32)
    views = [pkg.Mask(conv(pkg, m), labels=pkg.Labels(conv(pkg, lab)))
             .__get_view__(frame=frame).image for pkg in (P, J)]
    np.testing.assert_allclose(views[0], views[1], rtol=0, atol=1e-6)


def test_flow_view_equals_jax():
    rng = np.random.RandomState(10)
    f = rng.normal(0, 5, (2,) + HW).astype(np.float32)
    got = P.Flow(torch.from_numpy(f)).__get_view__().image
    want = J.Flow(f).__get_view__().image
    assert (got == want).all()
    got = P.Flow(torch.from_numpy(f)).__get_view__(magnitude_max=3.0).image
    want = J.Flow(f).__get_view__(magnitude_max=3.0).image
    assert (got == want).all()


@pytest.mark.parametrize("kind", ["depth", "disparity"])
@pytest.mark.parametrize("bounds", [False, True])
def test_colormapped_views_equal_matplotlib(kind, bounds):
    rng = np.random.RandomState(11)
    a = rng.uniform(0.5, 80, (1,) + HW).astype(np.float32)
    a[0, 0, :3] = (np.inf, 0.5, 80)
    if kind == "depth":
        kw = dict(min_depth=2.0, max_depth=40.0) if bounds else {}
        got = P.Depth(torch.from_numpy(a)).__get_view__(**kw).image
        want = J.Depth(a).__get_view__(**kw).image
    else:
        a[0, 0, 0] = 3.0
        kw = dict(min_disp=2.0, max_disp=40.0) if bounds else {}
        got = P.Disparity(torch.from_numpy(a)).__get_view__(**kw).image
        want = J.Disparity(a).__get_view__(**kw).image
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def full_frame(pkg):
    rng = np.random.RandomState(12)
    f = pkg.Frame(conv(pkg, rng_frame(rng)))
    f.append_boxes2d(boxes2d(pkg, labels=False))
    f.append_boxes3d(boxes3d(pkg, False))
    f.append_cam_intrinsic(intrinsic(pkg))
    m = (rng.uniform(0, 1, (3,) + HW) > 0.7).astype(np.float32)
    f.append_segmentation(pkg.Mask(conv(pkg, m)))
    return f


@pytest.mark.parametrize("kw", [dict(), dict(exclude=["segmentation"]),
                                dict(exclude=["boxes2d", "boxes3d"]),
                                dict(size=(48, 64))],
                         ids=["all", "exclude_mask", "exclude_boxes",
                              "size"])
def test_frame_get_view_with_every_child(kw):
    got = full_frame(P).get_view(**kw).image
    want = full_frame(J).get_view(**kw).image
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_frame_view_of_a_normalised_batch():
    rng = np.random.RandomState(13)
    a = np.stack([rng_frame(rng), rng_frame(rng)])
    got = P.Frame(torch.from_numpy(a), names=("T", "C", "H", "W")
                  ).norm_resnet().get_view(title="t").image
    want = J.Frame(a, names=("T", "C", "H", "W")).norm_resnet().get_view(
        title="t").image
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_child_view_errors_rise():
    """The JAX view drops a child whose view raises TypeError; the port's
    lets it rise."""
    f = full_frame(P)

    class Broken(P.Mask):
        def __get_view__(self, frame=None, **kwargs):
            raise TypeError("a fault in the child's view")
    f._children["segmentation"] = Broken(torch.zeros((1,) + HW))
    with pytest.raises(TypeError, match="fault"):
        f.get_view()


# ----------------------------------------------------------------------
# ObjectDetectorCallback
# ----------------------------------------------------------------------
class _Logger:
    def __init__(self):
        self.images = {}

    def log_image(self, name, image, step):
        self.images[name] = image


class _Trainer:
    def __init__(self, inference_fn, logger):
        self.inference_fn, self.logger, self.global_step = \
            inference_fn, logger, 7


def test_object_detector_callback_logs_the_jax_views(tmp_path):
    """The tiny DETR head's outputs (4 classes + background, 10 queries)
    through each package's ``inference`` and callback: the images read
    back from the port's event file equal JAX's callback's."""
    from functools import partial
    import aloception_tpu.models.detr.detr as jdetr
    import aloception_tpu.train.callbacks as jcb
    import aloception_tpu_torch.models.detr.detr as tdetr
    from aloception_tpu_torch.train import ObjectDetectorCallback
    from aloception_tpu_torch.train.logger import (TensorBoardLogger,
                                                   read_events)
    rng = np.random.RandomState(14)
    logits = rng.normal(0, 2, (2, 10, 5)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, 10, 2)),
                            rng.uniform(0.05, 0.4, (2, 10, 2))], -1
                           ).astype(np.float32)
    frames = np.stack([rng_frame(rng), rng_frame(rng)])

    def batch(pkg):
        f = pkg.Frame(conv(pkg, frames), names=("B", "C", "H", "W"))
        return {"frames": f.norm_resnet()}
    jt = _Trainer(partial(jdetr.inference, background_class=4), _Logger())
    cb = jcb.ObjectDetectorCallback()
    cb.on_val_batch_end(jt, {"pred_logits": logits, "pred_boxes": boxes},
                        batch(J), {})
    logger = TensorBoardLogger(str(tmp_path))
    tt = _Trainer(partial(tdetr.inference, background_class=4), logger)
    cb = ObjectDetectorCallback()
    out = {"pred_logits": torch.from_numpy(logits),
           "pred_boxes": torch.from_numpy(boxes)}
    cb.on_val_batch_end(tt, out, batch(P), {})
    cb.on_val_batch_end(tt, out, batch(P), {})      # once a pass
    logger.close()
    events = [e for e in read_events(logger.writer.path) if "image" in e]
    assert [e["tag"] for e in events] == ["val/pred_boxes_0",
                                          "val/pred_boxes_1"]
    for e in events:
        want = (jt.logger.images[e["tag"]] * 255.0).astype(np.uint8)
        assert e["step"] == 7 and e["image"].shape == want.shape
        same_px = (e["image"] == want).all(-1)
        assert same_px.mean() > 0.97
        jb = jdetr.inference({"pred_logits": logits, "pred_boxes": boxes},
                             background_class=4)[int(e["tag"][-1])]
        jb = jb.abs_pos(HW).xyxy()
        lab = np.asarray(jb.labels.as_numpy()).astype(int)
        txt = text_regions(np.asarray(jb.as_numpy()), [str(i) for i in lab],
                           np.asarray(jb.labels.scores))
        assert same_px[~txt].all()
