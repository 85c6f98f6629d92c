"""The 3-D geometry of the port's aloscene against the JAX package's, on the
CPU: camera calibration, Points2D/3D, OrientedBoxes2D, BoundingBoxes3D,
Depth, Disparity, SceneFlow, ``rotate``, the file readers and
``flow_to_color``, on the same numpy inputs through both packages, comparing
whole objects with ``same`` (payload, names, properties, children). The
semantic tests of ``tests/test_projections_depth.py``, the class cases of
``tests/test_rotated_iou_and_3d.py`` and the ``.flo``/``.pfm`` cases of
``tests/test_golden_formats.py`` are replayed on the port.

Tolerances: ``same``'s (1e-6 absolute plus one float32 ulp of the largest
value) on flips, crops, pads and the calibration; 1e-5 of the largest value
on conversions that divide or take roots (depth, disparity, rays, vertices,
projections); ``rotate`` against the JAX package's ``cv2.warpAffine``
within 1e-5 of the largest value: the port computes what OpenCV 5 computes
for float32 images, bit-equal on every column OpenCV vectorises (measured
0 on this CPU) and within one float32 ulp of the source coordinate on the
last W mod 16 columns, which OpenCV computes apart (measured 3.2e-6 of the
largest value at 37x53, 1.15e-4 at 375x1242)."""

import os

import numpy as np
import pytest
import torch

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc

from test_torch_aloscene import same
from torch_parity import jit_jax_pairwise

FX = os.path.join(os.path.dirname(__file__), "fixtures")
REL = 1e-5


@pytest.fixture(autouse=True)
def _jitted_jax_iou(monkeypatch):
    jit_jax_pairwise(monkeypatch)


def close_rel(got, want, rel=REL):
    """A port object (or tensor) against the JAX one within ``rel`` of the
    largest finite value; infinities and NaN must sit in the same places."""
    w = np.asarray(want if isinstance(want, np.ndarray) else want.as_numpy(),
                   np.float32)
    g = (got if isinstance(got, torch.Tensor) else got.array).detach().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    finite = np.isfinite(w)
    atol = rel * max(1.0, float(np.abs(w[finite]).max(initial=0.0)))
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    if not isinstance(want, np.ndarray):
        if not finite.all():
            got = got._with_array(torch.nan_to_num(got.array, posinf=0.0,
                                                   neginf=0.0))
            want = want._with_array(np.nan_to_num(w, posinf=0.0, neginf=0.0))
        same(got, want, rtol=rel, atol=atol)


def both(make):
    """``make(pkg, conv)`` built through the JAX package (numpy arrays) and
    the port (CPU tensors)."""
    return make(jsc, lambda a: a), make(tsc, torch.from_numpy)


def intrinsic(pkg, f=100.0, size=(64, 96), **kwargs):
    return pkg.CameraIntrinsic(focal_length=f, plane_size=size, **kwargs)


def depth_map(seed=1, shape=(1, 16, 24), lo=2.0, hi=30.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# camera calibration

def test_intrinsic_construction():
    K = intrinsic(tsc)
    assert torch.equal(K.focal_length, torch.tensor([100.0, 100.0]))
    assert torch.equal(K.principal_points, torch.tensor([48.0, 32.0]))
    same(K, intrinsic(jsc))
    for kwargs in ({"focal_length": (80.0, 90.0), "principal_point": (10, 20),
                    "skew": 0.5}, {"focal_length": 50.0}):
        same(tsc.CameraIntrinsic(**kwargs), jsc.CameraIntrinsic(**kwargs))


def scene(pkg, conv, h=64, w=96):
    """A 0-1 frame with an intrinsic, a depth map (with its own intrinsic
    and a baseline), 3D boxes with labels and 2D points."""
    f = pkg.Frame(conv(np.random.RandomState(0).uniform(0, 1, (3, h, w))
                       .astype(np.float32)), normalization="01")
    f.append_cam_intrinsic(intrinsic(pkg, size=(h, w)))
    d = pkg.Depth(conv(depth_map(shape=(1, h, w))), baseline=0.54)
    d.append_cam_intrinsic(intrinsic(pkg, size=(h, w)))
    f.append_depth(d)
    rng = np.random.RandomState(2)
    f.append_boxes3d(pkg.BoundingBoxes3D(
        conv(np.concatenate([rng.uniform(-5, 5, (6, 2)),
                             rng.uniform(5, 40, (6, 1)),
                             rng.uniform(1, 4, (6, 3)),
                             rng.uniform(-3, 3, (6, 1))], 1)
             .astype(np.float32)),
        labels=pkg.Labels(conv(np.arange(6, dtype=np.float32)))))
    f.append_points2d(pkg.Points2D(
        conv(rng.uniform(0, 1, (12, 2)).astype(np.float32)), "xy", False,
        labels=pkg.Labels(conv(np.arange(12, dtype=np.float32)))))
    return f


OPS = {"resize": ((32, 48),), "hflip": (), "vflip": (),
       "crop": ((0.25, 1.0), (0.1, 0.8)), "pad": ((0.25, 0.1), (0.3, 0.0))}


@pytest.mark.parametrize("op", sorted(OPS))
def test_scene_ops(op):
    """Each op on the whole scene: the intrinsics follow (focals and
    principal point), points move or drop, 3D boxes mirror or stay, the
    depth map moves (resize: 1e-5 of max; the rest: same's tolerance)."""
    jf, tf = both(scene)
    got, want = getattr(tf, op)(*OPS[op]), getattr(jf, op)(*OPS[op])
    if op == "resize":
        close_rel(got, want)
    else:
        same(got, want)


def test_intrinsic_transforms_with_frame():
    """The replayed cases of test_projections_depth.py on the port."""
    f = tsc.Frame(torch.zeros(3, 64, 96), normalization="01")
    f.append_cam_intrinsic(intrinsic(tsc))
    K = f.resize((32, 48)).cam_intrinsic.array
    assert K[0, 0] == K[1, 1] == 50 and (K[0, 2], K[1, 2]) == (24, 16)
    assert f.hflip().cam_intrinsic.array[0, 2] == 96 - 48
    Kc = f.crop((0.25, 1.0), (0.25, 1.0)).cam_intrinsic.array
    assert (Kc[0, 2], Kc[1, 2]) == (48 - 24, 32 - 16)
    Kp = f.pad((0.25, 0.0), (0.25, 0.0)).cam_intrinsic.array
    assert (Kp[0, 2], Kp[1, 2]) == (48 + 24, 32 + 16)


def test_flip_with_skew_raises():
    f = tsc.Frame(torch.zeros(3, 8, 8), normalization="01")
    f.append_cam_intrinsic(tsc.CameraIntrinsic(focal_length=10.0, skew=0.5))
    with pytest.raises(ValueError, match="skew"):
        f.hflip()


def test_extrinsic_translation_distance():
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [3.0, 0.0, 4.0]
    e1, e2 = tsc.CameraExtrinsic(torch.from_numpy(T1)), tsc.Pose(
        torch.from_numpy(T2))
    assert torch.allclose(e1.translation_with(e2), torch.tensor([3., 0, 4]),
                          atol=1e-5)
    assert abs(float(e1.distance_with(e2)) - 5.0) < 1e-5
    R = np.random.RandomState(0).randn(2, 4, 4).astype(np.float32)
    got = tsc.CameraExtrinsic(torch.from_numpy(R[0])).translation_with(
        tsc.CameraExtrinsic(torch.from_numpy(R[1])))
    close_rel(got, np.asarray(jsc.CameraExtrinsic(R[0]).translation_with(
        jsc.CameraExtrinsic(R[1]))))


# ---------------------------------------------------------------------------
# depth, disparity, points 3D

def with_intrinsic(pkg, depth, K, **kwargs):
    d = pkg.Depth(depth, **kwargs)
    d.append_cam_intrinsic(K)
    return d


def test_depth_points3d_roundtrip():
    K = intrinsic(tsc, f=50.0, size=(16, 24))
    depth = with_intrinsic(tsc, torch.full((1, 16, 24), 7.0), K)
    pts = depth.as_points3d()
    assert pts.shape == (16 * 24, 3) and pts.names == ("N", None)
    assert torch.allclose(pts.array[:, 2], torch.tensor(7.0), atol=1e-5)
    back = pts.as_depth(K, (16, 24))
    assert torch.allclose(back.array[0], torch.tensor(7.0), atol=1e-4)


@pytest.mark.parametrize("planar", [True, False])
def test_as_points3d_and_back(planar):
    """Planar or euclidean depth with NaN and infinities (set to 0) ->
    Points3D -> a depth map by projection, against the JAX package."""
    def make(pkg, conv):
        d = depth_map()
        d[0, 3, 4], d[0, 5, 6], d[0, 7, 8] = np.nan, np.inf, -np.inf
        return with_intrinsic(pkg, conv(d), intrinsic(pkg, 30.0, (16, 24)),
                              is_planar=planar)
    jd, td = both(make)
    got, want = td.as_points3d(), jd.as_points3d()
    close_rel(got, want)
    K = (intrinsic(tsc, 30.0, (16, 24)), intrinsic(jsc, 30.0, (16, 24)))
    close_rel(got.as_depth(K[0], (16, 24)), want.as_depth(K[1], (16, 24)))


def test_depth_disparity_roundtrip():
    K = intrinsic(tsc, f=80.0, size=(8, 8))
    depth = with_intrinsic(tsc, torch.full((1, 8, 8), 4.0), K, baseline=0.5)
    disp = depth.as_disp(camera_side="left", baseline=0.5)
    assert torch.allclose(disp.array, torch.tensor(0.5 * 80.0 / 4.0),
                          atol=1e-5)
    back = disp.as_depth(baseline=0.5, camera_intrinsic=K)
    assert torch.allclose(back.array, torch.tensor(4.0), atol=1e-4)


def test_depth_disparity_conversions_match_jax():
    """as_disp (zeros and NaN to 0) and as_depth (0 to infinity), with the
    intrinsic or a focal length."""
    def make(pkg, conv):
        d = depth_map(shape=(1, 8, 12))
        d[0, 0, :3] = [0.0, np.inf, np.nan]
        return with_intrinsic(pkg, conv(d), intrinsic(pkg, 80.0, (8, 12)),
                              baseline=0.54, camera_side="left")
    jd, td = both(make)
    got, want = td.as_disp(), jd.as_disp()
    close_rel(got, want)
    close_rel(got.as_depth(), want.as_depth())
    close_rel(got.as_depth(baseline=0.3, focal_length=70.0),
              want.as_depth(baseline=0.3, focal_length=70.0))


def test_depth_inverse_roundtrip_and_clamps():
    jd, td = both(lambda pkg, conv: pkg.Depth(conv(depth_map(0, (1, 8, 8),
                                                             1, 50))))
    inv = td.encode_inverse()
    assert not inv.is_absolute
    assert torch.allclose(inv.encode_absolute().array, td.array, rtol=1e-4)
    close_rel(inv, jd.encode_inverse())
    kwargs = dict(prior_clamp_min=2.0, prior_clamp_max=40.0,
                  post_clamp_max=0.4)
    close_rel(td.encode_inverse(**kwargs), jd.encode_inverse(**kwargs))
    kwargs = dict(scale=2.0, shift=-0.05, post_clamp_max=30.0)
    close_rel(inv.encode_absolute(**kwargs),
              jd.encode_inverse().encode_absolute(**kwargs))


def test_depth_planar_euclidean_roundtrip():
    K = intrinsic(tsc, f=30.0, size=(8, 8))
    d = with_intrinsic(tsc, torch.full((1, 8, 8), 5.0), K)
    eu = d.as_euclidean()
    assert not eu.is_planar and float(eu.array.min()) >= 5.0
    assert torch.allclose(eu.as_planar().array, torch.tensor(5.0), atol=1e-4)
    jd = with_intrinsic(jsc, np.full((1, 8, 8), 5.0, np.float32),
                        intrinsic(jsc, 30.0, (8, 8)))
    close_rel(eu, jd.as_euclidean())
    close_rel(eu.as_planar(), jd.as_euclidean().as_planar())


def test_batched_depth_uses_each_items_intrinsic():
    """Two depth maps whose frames were cropped differently carry two
    intrinsics after batch_list: the port back-projects each with its own
    (each item equals the unbatched JAX result); the JAX package takes the
    first intrinsic for both (ROADMAP C)."""
    def make(pkg, conv, seed):
        d = with_intrinsic(pkg, conv(depth_map(seed, (1, 16, 24))),
                           intrinsic(pkg, 30.0, (16, 24)), baseline=0.5)
        return d
    items = [both(lambda pkg, conv: make(pkg, conv, s)) for s in (1, 2)]
    items[1] = tuple(d.crop((0.25, 1.0), (0.25, 1.0)).pad((0, 4), (0, 6))
                     for d in items[1])
    jb = jsc.batch_list([items[0][0], items[1][0]])
    tb = tsc.batch_list([items[0][1], items[1][1]])
    K = tb.cam_intrinsic.array
    assert K.shape == (2, 4, 4) and not torch.equal(K[0], K[1])
    got = tb.as_points3d()
    assert got.shape == (2, 16 * 24, 3) and got.names == ("B", "N", None)
    for i, (jd, _) in enumerate(items):
        close_rel(got.array[i], np.asarray(jd.as_points3d().as_numpy()))
    close_rel(got.array[0], np.asarray(jb.as_points3d().as_numpy())[0])
    disp = tb.as_disp()
    for i, (jd, _) in enumerate(items):
        close_rel(disp.array[i], np.asarray(jd.as_disp().as_numpy()))
    # back to depth on the unpadded item (padding: 0 depth -> 0 disparity
    # -> infinite depth)
    close_rel(disp.as_depth().array[0], tb.array[0].numpy())


def test_disparity_ops_match_jax():
    """Resize scales the values by the width ratio; hflip negates a signed
    disparity and swaps the camera side; signed/unsigned."""
    def make(pkg, conv):
        return pkg.Disparity(conv(depth_map(3, (1, 16, 24), 1, 20)),
                             camera_side="left", baseline=0.5)
    jd, td = both(make)
    close_rel(td.resize((8, 36)), jd.resize((8, 36)))
    same(td.hflip(), jd.hflip())
    js, ts = jd.signed(), td.signed()
    same(ts, js)
    same(ts.hflip(), js.hflip())
    same(ts.unsigned(), js.unsigned())
    with pytest.raises(ValueError, match="positive"):
        tsc.Disparity(-td.array)
    with pytest.raises(ValueError, match="camera_side"):
        tsc.Disparity(td.array, disp_format="signed")


# ---------------------------------------------------------------------------
# points 2D

def points(pkg, conv, absolute=False):
    rng = np.random.RandomState(5)
    p = rng.uniform(0, 1, (20, 2)).astype(np.float32)
    if absolute:
        p = p * np.array([96, 64], np.float32)
    return pkg.Points2D(conv(p), "xy", absolute,
                        frame_size=(64, 96) if absolute else None,
                        labels=pkg.Labels(conv(np.arange(20, dtype=np.float32)),
                                          scores=conv(np.linspace(
                                              1, 0, 20).astype(np.float32))))


POINT_OPS = {"_hflip": (), "_vflip": (), "_resize": ((0.5, 2.0),),
             "_crop": ((0.2, 0.7), (0.1, 0.6)),
             "_pad": ((0.1, 0.3), (0.0, 0.2)),
             "_spatial_shift": (0.1, -0.2)}


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("op", sorted(POINT_OPS))
def test_points2d_ops_match_jax(op, absolute):
    jp, tp = both(lambda pkg, conv: points(pkg, conv, absolute))
    for fmt in ("xy", "yx"):
        got = getattr(tp.get_with_format(fmt), op)(*POINT_OPS[op])
        want = getattr(jp.get_with_format(fmt), op)(*POINT_OPS[op])
        close_rel(got, want)


def test_points2d_state_match_jax():
    jp, tp = both(points)
    same(tp.abs_pos((64, 96)), jp.abs_pos((64, 96)))
    same(tp.abs_pos((64, 96)).abs_pos((32, 40)),
         jp.abs_pos((64, 96)).abs_pos((32, 40)))
    same(tp.abs_pos((64, 96)).rel_pos(), jp.abs_pos((64, 96)).rel_pos())
    same(tp.yx().as_points(tp.abs_pos((10, 20))),
         jp.yx().as_points(jp.abs_pos((10, 20))))
    recorded = (tp._pad((0.1, 0.2), (0.3, 0.0), pad_points2d=False),
                jp._pad((0.1, 0.2), (0.3, 0.0), pad_points2d=False))
    same(recorded[0], recorded[1])
    same(recorded[0].fit_to_padded_size(), recorded[1].fit_to_padded_size())


def test_points2d_ops():
    """The replayed case of test_projections_depth.py on the port."""
    pts = tsc.Points2D(torch.tensor([[0.25, 0.5], [0.8, 0.2]]), "xy", False,
                       labels=tsc.Labels(torch.tensor([1.0, 2.0])))
    assert torch.allclose(pts._hflip().array[:, 0], torch.tensor([0.75, 0.2]))
    a = pts.abs_pos((100, 200))
    assert torch.allclose(a.array[0], torch.tensor([50.0, 50.0]))
    assert torch.allclose(a.rel_pos().array, pts.array)
    c = pts._crop((0.0, 0.6), (0.0, 0.6))
    assert c.shape[0] == 1 and c.labels.shape[0] == 1
    yx = pts.yx()
    assert torch.equal(yx.array[0], torch.tensor([0.5, 0.25]))
    assert torch.equal(yx.xy().array, pts.array)


def test_points2d_pad_and_fit():
    pts = tsc.Points2D(torch.tensor([[0.5, 0.5]]), "xy", False)
    padded = pts._pad((0.0, 1.0), (0.0, 1.0), pad_points2d=True)
    assert torch.allclose(padded.array[0], torch.tensor([0.25, 0.25]))
    recorded = pts._pad((0.0, 1.0), (0.0, 1.0), pad_points2d=False)
    assert recorded.padded_size is not None
    assert torch.allclose(recorded.fit_to_padded_size().array, padded.array)


# ---------------------------------------------------------------------------
# oriented boxes 2D, boxes 3D

def oriented(pkg, conv):
    rng = np.random.RandomState(6)
    b = np.concatenate([rng.uniform(10, 80, (8, 2)), rng.uniform(2, 20, (8, 2)),
                        rng.uniform(-np.pi, np.pi, (8, 1))], 1)
    return pkg.OrientedBoxes2D(conv(b.astype(np.float32)), absolute=True,
                               frame_size=(64, 96),
                               labels=pkg.Labels(conv(np.arange(
                                   8, dtype=np.float32))))


def test_oriented_boxes_2d_class():
    """The replayed case of test_rotated_iou_and_3d.py on the port."""
    boxes = tsc.OrientedBoxes2D(torch.tensor(
        [[4.0, 4.0, 2.0, 1.0, 0.0], [4.0, 4.0, 2.0, 1.0, np.pi / 2]]),
        absolute=True, frame_size=(10, 10))
    assert boxes.corners().shape == (2, 4, 2)
    iou = boxes.rotated_iou_with(boxes)
    assert torch.allclose(iou.diagonal(), torch.ones(2), atol=1e-3)
    assert 0.2 < iou[0, 1] < 0.6  # perpendicular overlap = 1/3
    assert torch.allclose(boxes.hflip().array[:, 0], torch.tensor(6.0))


def test_oriented_boxes_match_jax():
    jb, tb = both(oriented)
    close_rel(tb.corners(), jb.corners())
    close_rel(tb.rotated_iou_with(tb), jb.rotated_iou_with(jb))
    close_rel(tb.rotated_giou_with(tb), jb.rotated_giou_with(jb))
    for op, args in (("_hflip", ()), ("_vflip", ()), ("_resize", ((0.5, 2),)),
                     ("_crop", ((0.1, 0.9), (0.2, 0.7))),
                     ("_pad", ((0.1, 0.0), (0.2, 0.1))),
                     ("_spatial_shift", (0.1, -0.1))):
        close_rel(getattr(tb, op)(*args), getattr(jb, op)(*args))


def test_boxes3d_vertices_and_projection():
    """The replayed case of test_rotated_iou_and_3d.py on the port."""
    boxes = tsc.BoundingBoxes3D(torch.tensor([[0.0, 0, 10, 2, 1.5, 4, 0]]))
    v = boxes.get_vertices_3d()
    assert v.shape == (1, 8, 3)
    assert sorted(v[0, :, 0].unique().tolist()) == [-1, 1]
    assert float(v[0, :, 2].max()) == 12.0
    K = tsc.CameraIntrinsic(focal_length=100.0, plane_size=(100, 200))
    assert boxes.get_vertices_3d_proj(K).shape == (1, 8, 2)
    enc = boxes.get_enclosing_box_2d(K, frame_size=(100, 200))
    assert enc.boxes_format == "xyxy" and enc.absolute
    e = enc.array[0]
    assert e[0] < 100 < e[2] and e[1] < 50 < e[3]


def test_boxes3d_iou3d_with():
    b1 = tsc.BoundingBoxes3D(torch.tensor([[0.0, 0, 10, 2, 2, 2, 0]]))
    assert abs(float(b1.iou3d_with(b1)[0, 0]) - 1.0) < 1e-3
    assert abs(float(b1.giou3d_with(b1)[0, 0]) - 1.0) < 1e-3


def test_boxes3d_match_jax():
    jb, tb = scene(jsc, lambda a: a).boxes3d, scene(tsc, torch.from_numpy
                                                    ).boxes3d
    close_rel(tb.get_vertices_3d(), jb.get_vertices_3d())
    K = (intrinsic(tsc, 721.5377, (375, 1242)),
         intrinsic(jsc, 721.5377, (375, 1242)))
    close_rel(tb.get_vertices_3d_proj(K[0]), jb.get_vertices_3d_proj(K[1]))
    close_rel(tb.get_enclosing_box_2d(K[0], (375, 1242)),
              jb.get_enclosing_box_2d(K[1], (375, 1242)))
    close_rel(tb.bev_boxes(), jb.bev_boxes())
    other = (tb.array + torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, tb.shape).astype(np.float32)))
    t2, j2 = tsc.BoundingBoxes3D(other), jsc.BoundingBoxes3D(other.numpy())
    close_rel(tb.iou3d_with(t2), jb.iou3d_with(j2))
    close_rel(tb.giou3d_with(t2), jb.giou3d_with(j2))
    same(tb._vflip(), jb._vflip())
    same(tb._hflip(), jb._hflip())
    E = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    E[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    E[:3, 3] = [1.0, -1.5, 0.7]
    close_rel(tb._hflip(cam_extrinsic=tsc.CameraExtrinsic(torch.from_numpy(E))),
              jb._hflip(cam_extrinsic=jsc.CameraExtrinsic(E)))


def test_batched_boxes3d_project_with_each_items_intrinsic():
    """(B, N, 7) boxes under a (B, 4, 4) intrinsic: each item projects
    with its own matrix."""
    b = scene(tsc, torch.from_numpy).boxes3d.array
    K = torch.stack([intrinsic(tsc, 100.0).array, intrinsic(tsc, 300.0).array])
    got = tsc.BoundingBoxes3D(torch.stack([b, b]), names=("B", "N", None)
                              ).get_vertices_3d_proj(tsc.CameraIntrinsic(K))
    for i in range(2):
        want = tsc.BoundingBoxes3D(b).get_vertices_3d_proj(
            tsc.CameraIntrinsic(K[i]))
        assert torch.equal(got[i * len(b):(i + 1) * len(b)], want)


# ---------------------------------------------------------------------------
# rotate, batch_list

def rotation_scene(pkg, conv, h=37, w=53, dtype=np.float32):
    """A frame with a mask, depth, flow and disparity (the JAX package
    rotates all of them with cv2)."""
    rng = np.random.RandomState(8)
    f = pkg.Frame(conv(rng.uniform(0, 255, (3, h, w)).astype(dtype)))
    f.append_depth(pkg.Depth(conv(depth_map(9, (1, h, w)))))
    f.append_flow(pkg.Flow(conv(rng.randn(2, h, w).astype(np.float32))))
    f.append_disparity(pkg.Disparity(conv(depth_map(10, (1, h, w), 0, 9))))
    f.append_mask(pkg.Mask(conv((rng.uniform(0, 1, (1, h, w)) > 0.5)
                                .astype(np.float32)), names=("C", "H", "W")))
    return f


@pytest.mark.parametrize("case", [(37, 53, 5.0, None), (64, 96, -30.0, None),
                                  (40, 40, 90.0, None),
                                  (37, 53, 12.0, (10.5, 20.0))])
def test_rotate_matches_cv2(case):
    h, w, angle, center = case
    jf, tf = both(lambda pkg, conv: rotation_scene(pkg, conv, h, w))
    close_rel(tf.rotate(angle, center), jf.rotate(angle, center))


def test_rotate_uint8_truncates_as_numpy():
    jf, tf = both(lambda pkg, conv: rotation_scene(pkg, conv,
                                                   dtype=np.uint8))
    got, want = tf.rotate(7.0), jf.rotate(7.0)
    assert got.dtype == torch.uint8
    diff = np.abs(got.as_numpy().astype(int) - want.as_numpy().astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_batch_list_with_3d_children():
    """Frames of different sizes and N: depth, disparity and the
    intrinsics merge on B; points, 3D and oriented boxes become per-item
    lists; points keep their padded_size."""
    def make(pkg, conv, seed):
        f = scene(pkg, conv)
        if seed:
            f = f.crop((0.0, 0.75), (0.1, 0.9))
        f.append_disparity(pkg.Disparity(
            conv(depth_map(seed, (1,) + f.HW, 1, 9)), baseline=0.5))
        return f
    pairs = [both(lambda pkg, conv: make(pkg, conv, s)) for s in (0, 1)]
    want = jsc.batch_list([p[0] for p in pairs])
    got = tsc.batch_list([p[1] for p in pairs])
    assert isinstance(got.points2d, list) and got.points2d[0].shape[0] == 12
    assert got.points2d[1].shape[0] != 12
    same(got, want)
    same(tsc.temporal_list([p[1] for p in pairs[:1]] * 2),
         jsc.temporal_list([p[0] for p in pairs[:1]] * 2))


# ---------------------------------------------------------------------------
# scene flow, file readers, flow colours

def test_scene_flow_from_optical_flow():
    """P2(x + flow, Z2) - P1(x, Z1), against numpy (the JAX package reshapes
    a 4x4 intrinsic to 3x3 and fails)."""
    rng = np.random.RandomState(12)
    flow = rng.randn(2, 16, 24).astype(np.float32)
    z1, z2 = depth_map(13, (1, 16, 24)), depth_map(14, (1, 16, 24))
    K = intrinsic(tsc, 30.0, (16, 24))
    occ = tsc.Mask(torch.zeros(1, 16, 24), names=("C", "H", "W"))
    sf = tsc.SceneFlow.from_optical_flow(
        tsc.Flow(torch.from_numpy(flow), occlusion=occ),
        tsc.Depth(torch.from_numpy(z1)), tsc.Depth(torch.from_numpy(z2)), K)
    ys, xs = np.mgrid[:16, :24].astype(np.float32)
    k = K.as_numpy()

    def unproject(x, y, z):
        return np.stack([(x - k[0, 2]) / k[0, 0] * z,
                         (y - k[1, 2]) / k[1, 1] * z, z], 0)
    want = unproject(xs + flow[0], ys + flow[1], z2[0]) \
        - unproject(xs, ys, z1[0])
    close_rel(sf.array, want)
    assert sf.names == ("C", "H", "W") and sf.occlusion is not None


def test_flo_and_pfm_goldens():
    """The golden files through the port's readers and constructors,
    exactly (the cases of test_golden_formats.py)."""
    from aloception_tpu_torch.aloscene.io.disparity import load_pfm
    from aloception_tpu_torch.aloscene.io.flow import load_flow_flo
    flow = load_flow_flo(os.path.join(FX, "golden.flo"))
    want = np.load(os.path.join(FX, "golden_flo_expected.npy"))  # (H, W, 2)
    assert flow.shape == (2, 2, 3)
    np.testing.assert_array_equal(np.moveaxis(flow.numpy(), 0, -1), want)
    np.testing.assert_array_equal(np.moveaxis(
        tsc.Flow(os.path.join(FX, "golden.flo")).as_numpy(), 0, -1), want)
    pfm = np.load(os.path.join(FX, "golden_pfm_expected.npy"))
    np.testing.assert_array_equal(
        load_pfm(os.path.join(FX, "golden.pfm")).numpy().reshape(pfm.shape),
        pfm)
    disp = tsc.Disparity(os.path.join(FX, "golden.pfm"),
                         disp_format="signed", camera_side="left")
    np.testing.assert_array_equal(disp.as_numpy().reshape(pfm.shape), pfm)


def test_readers_roundtrip_against_jax(tmp_path):
    """save_flow_flo -> load_flow, .npy flow and depth, .npz depth: both
    packages read the same values."""
    from aloception_tpu.aloscene.io import depth as jdepth, flow as jflow
    from aloception_tpu_torch.aloscene.io import depth as tdepth, flow as tflow
    rng = np.random.RandomState(15)
    flow = rng.randn(2, 5, 7).astype(np.float32)
    tflow.save_flow_flo(str(tmp_path / "a.flo"), torch.from_numpy(flow))
    np.save(tmp_path / "b.npy", flow.transpose(1, 2, 0))
    for name in ("a.flo", "b.npy"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(tflow.load_flow(path).numpy(),
                                      jflow.load_flow(path))
    depth = rng.uniform(1, 9, (5, 7)).astype(np.float32)
    np.save(tmp_path / "d.npy", depth)
    np.savez(tmp_path / "d.npz", depth)
    for name in ("d.npy", "d.npz"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(tdepth.load_depth(path).numpy(),
                                      jdepth.load_depth(path))
        same(tsc.Depth(path), jsc.Depth(path))
    for bad in ("x.bin", "x.jpg"):
        with pytest.raises(tsc.InvalidSampleError):
            tdepth.load_depth(bad)
        with pytest.raises(tsc.InvalidSampleError):
            tflow.load_flow(bad)


@pytest.mark.parametrize("kwargs", [{}, {"magnitude_max": 7.3},
                                    {"clip_flow": 3.0, "convert_to_bgr": True}])
def test_flow_to_color_bit_equal(kwargs):
    from aloception_tpu.aloscene.utils.flow_utils import flow_to_color as jf
    from aloception_tpu_torch.aloscene.utils.flow_utils import flow_to_color
    flow = (np.random.RandomState(16).randn(48, 64, 2) * 5).astype(np.float32)
    np.testing.assert_array_equal(
        flow_to_color(torch.from_numpy(flow), **kwargs).numpy(),
        jf(flow, **kwargs))
