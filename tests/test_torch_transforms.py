"""The port's 26 transforms (``aloception_tpu_torch/alodataset/transforms``)
against the JAX package's: the same parameters set on both sides
(``set_params``; the port draws them from a seeded ``torch.Generator``),
applied to a frame carrying boxes, masks, flow, disparity and points, the
whole result compared (payload, names, properties, children) within 1e-5 of
max|ref|; crops, flips and pads equal. Also the same-on-sequence and
same-on-frames cases, and replays of ``tests/test_dataset.py``'s transform
cases on the port."""

import numpy as np
import pytest
import torch

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu.alodataset import transforms as JT
from aloception_tpu_torch.alodataset import transforms as TT
from aloception_tpu_torch.alodataset import FlyingChairs2Dataset

from test_torch_aloscene import same

RTOL = 1e-5
# the bilinear resize (F.interpolate against the JAX package's cv2 path):
# its weights differ in the last bits, 1.1e-5 of max|ref| at worst on the
# flow child here; ``tests/test_torch_aloscene.py`` holds the op itself
RESIZE_RTOL = 2e-5
RESIZING = ("Resize", "RandomResizeWithAspectRatio", "RandomDownScale",
            "RandomDownScale_ratio")


def rich(pkg, conv, h=48, w=64, seed=0, norm="255"):
    """A frame with boxes2d (labelled), a segmentation Mask, a flow with its
    occlusion, an unsigned disparity and points2d."""
    rng = np.random.RandomState(seed)
    f = pkg.Frame(conv(rng.uniform(0, 255, (3, h, w)).astype(np.float32)),
                  normalization="255")
    lab = pkg.Labels(conv(np.array([1, 3], np.float32)),
                     labels_names=["a", "b", "c", "d"])
    f.append_boxes2d(pkg.BoundingBoxes2D(
        conv(np.array([[0.5, 0.5, 0.2, 0.3], [0.3, 0.6, 0.1, 0.2]],
                      np.float32)), "xcyc", False, labels=lab))
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:30, 12:40] = 1
    masks[1, 20:44, 5:20] = 1
    f.append_segmentation(pkg.Mask(conv(masks), labels=lab.clone()))
    occ = (rng.rand(1, h, w) > 0.8).astype(np.float32)
    f.append_flow(pkg.Flow(conv(rng.uniform(-3, 3, (2, h, w)).astype(
        np.float32)), occlusion=pkg.Mask(conv(occ), names=("C", "H", "W"))))
    f.append_disparity(pkg.Disparity(conv(rng.uniform(1, 20, (1, h, w)).astype(
        np.float32))))
    f.append_points2d(pkg.Points2D(conv(rng.uniform(0.05, 0.95, (5, 2)).astype(
        np.float32)), "xy", False))
    return f if norm == "255" else f.norm01()


def pair(**kw):
    return rich(jsc, lambda a: a, **kw), rich(tsc, torch.from_numpy, **kw)


# name: (constructor of a transform from (transforms module, its extra
# keyword arguments)), exact?, frame normalization, apply kwargs
CASES = {
    "RandomHorizontalFlip": (lambda T, k: T.RandomHorizontalFlip(0.5, **k),
                             True, "255", {}),
    "RandomVerticalFlip": (lambda T, k: T.RandomVerticalFlip(0.5, **k),
                           True, "255", {}),
    "RandomSizeCrop_int": (lambda T, k: T.RandomSizeCrop(20, 40, **k),
                           True, "255", {}),
    "RandomSizeCrop_float": (lambda T, k: T.RandomSizeCrop(0.4, 0.9, **k),
                             True, "255", {}),
    "RandomCrop": (lambda T, k: T.RandomCrop((30, 41), **k), True, "255", {}),
    "RandomPad": (lambda T, k: T.RandomPad((60, 80), (48, 64), **k), True,
                  "255", {}),
    "RandomSizePad": (lambda T, k: T.RandomSizePad((60, 80), (48, 64), **k),
                      True, "255", {}),
    "RandomResizeWithAspectRatio": (
        lambda T, k: T.RandomResizeWithAspectRatio([32, 40, 56], 70, **k),
        False, "255", {}),
    "Resize": (lambda T, k: T.Resize((37, 51), **k), False, "255", {}),
    "Rotate": (lambda T, k: T.Rotate(12.5, **k), False, "255", {}),
    "RealisticNoise": (lambda T, k: T.RealisticNoise(**k), False, "255", {}),
    "CustomRandomColoring": (lambda T, k: T.CustomRandomColoring(**k), False,
                             "01", {}),
    "SpatialShift": (lambda T, k: T.SpatialShift((0.1, 0.3), **k), False,
                     "255", {}),
    "GrayScale": (lambda T, k: T.GrayScale(**k), False, "255", {}),
    "ColorJitter": (lambda T, k: T.ColorJitter(**k), False, "255", {}),
    "ColorJitter_hue": (lambda T, k: T.ColorJitter(0.0, 0.0, 0.0, 0.5, **k),
                        False, "01", {}),
    "RandomDownScale": (lambda T, k: T.RandomDownScale((20, 30), **k), False,
                        "255", {}),
    "RandomDownScale_ratio": (
        lambda T, k: T.RandomDownScale((20, 30), True, **k), False, "255", {}),
    "DynamicCropTransform": (
        lambda T, k: T.DynamicCropTransform((20, 30), **k), True, "255",
        {"center": (0.3, 0.7)}),
    "DynamicCropTransform_px": (
        lambda T, k: T.DynamicCropTransform((20, 30), **k), True, "255",
        {"center": (40, 10)}),
    "RandomFocusBlur": (lambda T, k: T.RandomFocusBlur(**k), False, "255",
                        {}),
    "RandomFocusBlurV2": (lambda T, k: T.RandomFocusBlurV2(**k), False,
                          "255", {}),
    "RandomFocusBlurV3": (lambda T, k: T.RandomFocusBlurV3(**k), False,
                          "255", {}),
    "RandomFlowMotionBlur": (lambda T, k: T.RandomFlowMotionBlur(**k), False,
                             "255", {}),
    "RandomCornersMask": (lambda T, k: T.RandomCornersMask(**k), False,
                          "255", {}),
}


def patch_noise(monkeypatch, seed):
    """The same noise on both sides: numpy's normal for the JAX package,
    ``RealisticNoise.noise`` for the port, from one seeded stream."""
    rng = np.random.RandomState(seed)
    draws = {}

    def draw(i, std, shape):
        if i not in draws:
            draws[i] = rng.normal(0, 1, shape)
        return (std * draws[i]).astype(np.float32)
    jn, tn = [0], [0]

    def jax_normal(loc, scale, size):
        jn[0] += 1
        return draw(jn[0], scale, size)

    def port_noise(self, std, like):
        tn[0] += 1
        return torch.from_numpy(draw(tn[0], std, tuple(like.shape)))
    monkeypatch.setattr(JT.np.random, "normal", jax_normal)
    monkeypatch.setattr(TT.RealisticNoise, "noise", port_noise)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_matches_jax(name, seed, monkeypatch):
    make, exact, norm, kwargs = CASES[name]
    g = torch.Generator().manual_seed(seed)
    tt, jt = make(TT, {"generator": g}), make(JT, {})
    params = tt.sample_params()
    tt.set_params(*params)
    jt.set_params(*params)
    patch_noise(monkeypatch, seed)
    jf, tf = pair(seed=seed, norm=norm)
    got, want = tt.apply(tf, **kwargs), jt.apply(jf, **kwargs)
    if exact:
        same(got, want, rtol=0, atol=0)
    else:
        same(got, want, rtol=RESIZE_RTOL if name in RESIZING else RTOL,
             atol=1e-6)


def fixed_params(t, params):
    """Make ``t`` draw ``params`` in turn (one tuple a ``sample_params``)."""
    it = iter(params)
    t.sample_params = lambda: next(it)
    return t


def test_compose_and_random_select_match_jax():
    """Deterministic children: Compose runs each in turn; RandomSelect
    takes the branch its drawn value picks."""
    for p_sel, r in ((0.5, 0.2), (0.5, 0.7)):
        outs = []
        for T, pkg_frames in ((TT, pair()[1]), (JT, pair()[0])):
            t = T.Compose([T.Resize((32, 40)), T.RandomHorizontalFlip(1.0),
                           T.RandomSelect(T.Resize((16, 24)),
                                          T.Resize((24, 16)), p=p_sel)])
            t.transforms[2].set_params(r, ((16, 24),), ((24, 16),))
            out = t.transforms[0].apply(pkg_frames)
            out = t.transforms[1](out)
            outs.append(t.transforms[2].apply(out))
        same(outs[0], outs[1], rtol=RESIZE_RTOL, atol=1e-6)


def test_random_down_scale_crop_matches_jax():
    outs = []
    for T, f in ((TT, pair()[1]), (JT, pair()[0])):
        t = T.RandomDownScaleCrop((24, 32))
        fixed_params(t.transforms[0], [(0.3, 0.8)])
        fixed_params(t.transforms[1], [(0.4, 0.9)])
        outs.append(t.apply(f))
    assert outs[0].HW == (24, 32)
    same(outs[0], outs[1], rtol=RESIZE_RTOL, atol=1e-6)


def test_ir_augmentation_matches_jax(monkeypatch):
    patch_noise(monkeypatch, 5)
    outs = []
    for T, f in ((TT, pair()[1]), (JT, pair()[0])):
        t = T.IRAugmentation()
        fixed_params(t.transforms[2], [(3, 2)])
        outs.append(t.apply(f))
    same(outs[0], outs[1], rtol=RTOL, atol=1e-6)


def test_not_same_on_sequence_draws_each_step():
    """same_on_sequence=False: each step of a T=2 frame takes its own draw
    (here: flip the first step only), as in the JAX package."""
    outs = []
    for T, pkg, conv in ((TT, tsc, torch.from_numpy), (JT, jsc, lambda a: a)):
        f = pkg.temporal_list([rich(pkg, conv, seed=s) for s in (3, 4)])
        t = fixed_params(T.RandomHorizontalFlip(0.5, same_on_sequence=False),
                         [(0.2,), (0.8,)])
        outs.append(t(f))
    same(outs[0], outs[1], rtol=0, atol=0)
    got = outs[0].array
    want0 = rich(tsc, torch.from_numpy, seed=3).hflip().array
    assert torch.equal(got[0], want0)


@pytest.mark.parametrize("same_frames", [True, False])
def test_dict_of_frames_same_on_frames(same_frames):
    """A dict of frames: one draw for all with same_on_frames, one each
    without; both packages alike."""
    outs = []
    for T, pkg, conv in ((TT, tsc, torch.from_numpy), (JT, jsc, lambda a: a)):
        frames = {"left": rich(pkg, conv, seed=5),
                  "right": rich(pkg, conv, seed=6)}
        t = fixed_params(T.RandomCrop((20, 30), same_on_frames=same_frames),
                         [(0.1, 0.9), (0.8, 0.2)])
        outs.append(t(frames))
    for k in ("left", "right"):
        same(outs[0][k], outs[1][k], rtol=0, atol=0)
    left, right = outs[0]["left"], outs[0]["right"]
    crop = rich(tsc, torch.from_numpy, seed=6).crop(
        (int(0.1 * 29) / 48, (int(0.1 * 29) + 20) / 48),
        (int(0.9 * 35) / 64, (int(0.9 * 35) + 30) / 64))
    assert torch.equal(right.array, crop.array) == same_frames
    assert left.HW == right.HW == (20, 30)


def test_same_on_frames_with_sequences():
    """Dict of T=2 frames, same_on_frames and not same_on_sequence: step t of
    every frame shares the t-th draw."""
    outs = []
    for T, pkg, conv in ((TT, tsc, torch.from_numpy), (JT, jsc, lambda a: a)):
        frames = {k: pkg.temporal_list([rich(pkg, conv, seed=s + 2 * i)
                                        for s in (7, 8)])
                  for i, k in enumerate(("left", "right"))}
        t = fixed_params(T.RandomVerticalFlip(0.5, same_on_sequence=False,
                                              same_on_frames=True),
                         [(0.1,), (0.9,)])
        outs.append(t(frames))
    for k in ("left", "right"):
        same(outs[0][k], outs[1][k], rtol=0, atol=0)


def test_probability_gate_uses_the_generator():
    """p gates the whole transform with a draw from the generator: the same
    seed gives the same outcome."""
    res = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        t = TT.Resize((10, 12), p=0.5, generator=g)
        res.append([t(rich(tsc, torch.from_numpy)).HW for _ in range(8)])
    assert res[0] == res[1]
    assert {(10, 12), (48, 64)} == set(res[0])


@pytest.mark.parametrize("shape", [(1, 40, 60), (4, 40, 60), (2, 3, 40, 60)])
def test_hsv_round_trip_matches_cv2(shape):
    """The hue path alone: RGB -> HSV -> RGB on random colours equals
    OpenCV's float conversion within 1e-5."""
    import cv2
    rng = np.random.RandomState(shape[0])
    img = rng.rand(*shape[-2:], 3).astype(np.float32)
    img[0, :5] = img[0, :5, :1]         # grey pixels (s = 0)
    want_hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got_hsv = TT.rgb_to_hsv(torch.from_numpy(img))
    hue_err = np.abs(got_hsv[..., 0].numpy() - want_hsv[..., 0])
    hue_err = np.minimum(hue_err, 360 - hue_err)
    assert hue_err.max() <= 1e-3 and np.abs(
        got_hsv[..., 1:].numpy() - want_hsv[..., 1:]).max() <= 1e-5
    want = cv2.cvtColor(want_hsv, cv2.COLOR_HSV2RGB)
    got = TT.hsv_to_rgb(torch.from_numpy(want_hsv)).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("size", [2, 5, 11, 15])
def test_filter2d_matches_cv2(size):
    import cv2
    rng = np.random.RandomState(size)
    img = rng.uniform(0, 255, (3, 30, 41)).astype(np.float32)
    kernel = TT.motion_kernel(size, 0.7)
    want = cv2.filter2D(img.transpose(1, 2, 0), -1, kernel.numpy())
    got = TT.filter2d_reflect101(torch.from_numpy(img), kernel)
    assert np.abs(got.numpy().transpose(1, 2, 0) - want).max() <= 1e-5 * 255


# replays of tests/test_dataset.py's transform cases on the port
def _frame_with_boxes(h=64, w=80, seed=0):
    rng = np.random.RandomState(seed)
    f = tsc.Frame(torch.from_numpy(
        rng.uniform(0, 255, (3, h, w)).astype(np.float32)))
    f.append_boxes2d(tsc.BoundingBoxes2D(
        torch.tensor([[0.5, 0.5, 0.2, 0.2], [0.3, 0.6, 0.1, 0.2]]),
        "xcyc", False))
    return f


def test_compose_and_resize():
    t = TT.Compose([TT.Resize((32, 40)), TT.RandomHorizontalFlip(p=1.0)])
    out = t(_frame_with_boxes())
    assert out.HW == (32, 40)
    assert np.allclose(out.boxes2d.array[0, 0].item(), 0.5, atol=1e-5)
    assert np.allclose(out.boxes2d.array[1, 0].item(), 0.7, atol=1e-5)


def test_random_select_deterministic_branches():
    t = TT.RandomSelect(TT.Resize((16, 16)), TT.Resize((32, 32)), p=1.0)
    assert t(_frame_with_boxes()).HW == (16, 16)
    t2 = TT.RandomSelect(TT.Resize((16, 16)), TT.Resize((32, 32)), p=0.0)
    assert t2(_frame_with_boxes()).HW == (32, 32)


def test_random_size_crop_bounds():
    t = TT.RandomSizeCrop(20, 40, generator=torch.Generator().manual_seed(0))
    for _ in range(5):
        out = t(_frame_with_boxes())
        assert 20 <= out.H <= 40 and 20 <= out.W <= 40


def test_resize_aspect_ratio():
    t = TT.RandomResizeWithAspectRatio([48], max_size=70)
    out = t(_frame_with_boxes(64, 100))
    assert min(out.HW) <= 48 and max(out.HW) <= 70


def test_same_on_frames_shares_params():
    t = TT.RandomSizeCrop(20, 40, same_on_frames=True, same_on_sequence=True,
                          generator=torch.Generator().manual_seed(0))
    out = t({"a": _frame_with_boxes(seed=1), "b": _frame_with_boxes(seed=2)})
    assert out["a"].HW == out["b"].HW


def test_same_on_sequence_false_varies():
    frames = FlyingChairs2Dataset(sample=True)[0]
    out = TT.RealisticNoise(same_on_sequence=False)(frames)
    assert out.shape == frames.shape


def test_color_transforms_preserve_norm():
    f = _frame_with_boxes().norm01()
    for t in [TT.GrayScale(), TT.ColorJitter(), TT.CustomRandomColoring(),
              TT.RealisticNoise(), TT.RandomFocusBlur(), TT.RandomFocusBlurV2(),
              TT.RandomFocusBlurV3(), TT.RandomCornersMask()]:
        out = t(f)
        assert out.shape == f.shape, type(t).__name__
        assert out.normalization == "01", type(t).__name__
        a = out.array
        assert a.min() >= -1e-4 and a.max() <= 1 + 1e-4, type(t).__name__


def test_spatial_shift_transform():
    out = TT.SpatialShift((0.1, 0.2))(_frame_with_boxes())
    assert tuple(out.shape) == (3, 64, 80)


def test_ir_augmentation():
    out = TT.IRAugmentation()(_frame_with_boxes())
    assert tuple(out.shape) == (3, 64, 80)
    assert out.norm01().array.shape[0] == 3
