"""The 3-D geometry of the port on the card against the same code on the
CPU: the five rotated / 3D IoU functions and ``pairwise`` on seeded pairs
(1e-5 absolute), a scene's geometric chain and conversions, the 3D AP and
the depth metrics. Card only: each test skips without a CUDA card. Imports
no JAX package (the card machine has jax but no flax)."""

import numpy as np
import pytest
import torch

import aloception_tpu_torch.aloscene as tsc
from aloception_tpu_torch import metrics
from aloception_tpu_torch.ops import rotated_iou as riou


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_boxes(rng, n, dims):
    return torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (n, dims)), rng.uniform(0.2, 2.0, (n, dims)),
         rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["cal_iou", "cal_giou", "cal_iou_3d",
                                  "cal_giou_3d", "cal_diou_3d"])
def test_iou_card_matches_cpu(cuda, func):
    rng = np.random.RandomState(0)
    dims = 2 if func in ("cal_iou", "cal_giou") else 3
    b1, b2 = random_boxes(rng, 4096, dims), random_boxes(rng, 4096, dims)
    fn = getattr(riou, func)
    cpu = fn(b1, b2)
    card = fn(b1.to(cuda), b2.to(cuda))
    for c, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (cpu, card))):
        assert g.device.type == "cuda"
        assert float((g.cpu() - c).abs().max()) <= 1e-5
    pair = riou.pairwise(fn, b1[:50].to(cuda), b2[:40].to(cuda))
    pair = pair[0] if isinstance(pair, tuple) else pair
    ref = riou.pairwise(fn, b1[:50], b2[:40])
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert pair.shape == (50, 40)
    assert float((pair.cpu() - ref).abs().max()) <= 1e-5


def scene(device):
    rng = np.random.RandomState(1)
    f = tsc.Frame(torch.from_numpy(rng.uniform(0, 255, (3, 64, 96)).astype(
        np.float32)))
    f.append_cam_intrinsic(tsc.CameraIntrinsic(focal_length=70.0,
                                               plane_size=(64, 96)))
    d = tsc.Depth(torch.from_numpy(rng.uniform(2, 40, (1, 64, 96)).astype(
        np.float32)), baseline=0.54)
    d.append_cam_intrinsic(tsc.CameraIntrinsic(focal_length=70.0,
                                               plane_size=(64, 96)))
    f.append_depth(d)
    f.append_points2d(tsc.Points2D(torch.from_numpy(
        rng.uniform(0, 1, (20, 2)).astype(np.float32)), "xy", False))
    return f.to(device)


@pytest.mark.cuda
def test_scene_chain_card_matches_cpu(cuda):
    def chain(f):
        f = f.resize((48, 72)).crop((0.1, 0.9), (0.05, 0.95)).hflip()
        f = f.pad((0.0, 0.1), (0.05, 0.0))
        return f, f.depth.rotate(5.0).as_points3d(), f.depth.as_disp()
    for got, want in zip(chain(scene(cuda)), chain(scene("cpu"))):
        assert got.device.type == "cuda" and got.shape == want.shape
        ref = want.array
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got.array.cpu() - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_metrics_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    gt = torch.from_numpy(np.concatenate(
        [rng.uniform(-10, 10, (20, 3)), rng.uniform(1, 4, (20, 3)),
         rng.uniform(-3, 3, (20, 1))], 1).astype(np.float32))
    pred = gt + 0.2 * torch.from_numpy(rng.randn(20, 7).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, 20).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, 20).astype(np.float32))
    maps = []
    for device in ("cpu", cuda):
        m = metrics.ApMetrics3D()
        m.add_sample(tsc.BoundingBoxes3D(pred, labels=tsc.Labels(
            labels, scores=scores)).to(device),
            tsc.BoundingBoxes3D(gt, labels=tsc.Labels(labels)).to(device))
        maps.append(m.calc_map())
    assert maps[0] == maps[1]
    t = torch.from_numpy(rng.uniform(0.5, 90, (1, 64, 96)).astype(np.float32))
    p = t * torch.from_numpy(rng.uniform(0.8, 1.2, (1, 64, 96)).astype(
        np.float32))
    keys = []
    for device in ("cpu", cuda):
        m = metrics.DepthMetrics()
        m.add_sample(p.to(device), t.to(device))
        keys.append(m.calc_map())
    for k, v in keys[0].items():
        assert abs(keys[1][k] - v) <= 1e-9 * abs(v), k
