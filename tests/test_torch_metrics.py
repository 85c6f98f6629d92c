"""The port's own ``ApMetrics`` and ``PQMetrics`` against the JAX package's:
every AP and PQ case of ``tests/test_metrics.py`` replayed on both, with
the same assertions on the port's numbers and the two packages' numbers
equal, and random cases (many boxes and classes, overlapping masks, empty
predictions, masks on the card's device type when there is one)."""

import numpy as np
import pytest
import torch

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu import metrics as jmetrics
from aloception_tpu_torch import metrics as tmetrics

NAMES = ("a", "b", "c")


def boxes(pkg, data, labels, scores=None, names=NAMES):
    arr = np.asarray(data, np.float32).reshape(-1, 4)
    lab = np.asarray(labels, np.float32)
    sc = None if scores is None else np.asarray(scores, np.float32)
    if pkg is tsc:
        arr, lab = torch.from_numpy(arr), torch.from_numpy(lab)
        sc = None if sc is None else torch.from_numpy(sc)
    return pkg.BoundingBoxes2D(arr, boxes_format="xyxy", absolute=False,
                               labels=pkg.Labels(lab, scores=sc,
                                                 labels_names=names))


def mask(pkg, data, labels):
    arr = np.asarray(data, np.float32)
    lab = np.asarray(labels, np.float32)
    if pkg is tsc:
        arr, lab = torch.from_numpy(arr), torch.from_numpy(lab)
    return pkg.Mask(arr, labels=pkg.Labels(lab))


def both_ap(samples, **kwargs):
    """(port's calc_map, JAX's) after the same (pred, gt) samples, each a
    pair of (boxes, labels, scores) tuples."""
    out = []
    for pkg, metrics in ((tsc, tmetrics), (jsc, jmetrics)):
        m = metrics.ApMetrics(**kwargs)
        for pred, gt in samples:
            m.add_sample(boxes(pkg, *pred), boxes(pkg, *gt))
        out.append(m.calc_map())
    assert out[0] == out[1]
    return out[0]


def both_pq(samples):
    """(port's PQMetrics, JAX's) after the same (pred, gt[, isthing])
    samples of (masks, labels)."""
    out = []
    for pkg, metrics in ((tsc, tmetrics), (jsc, jmetrics)):
        m = metrics.PQMetrics()
        for pred, gt, *isthing in samples:
            m.add_sample(mask(pkg, *pred), mask(pkg, *gt), *isthing)
        out.append(m)
    tm, jm = out
    assert tm.pq_per_cat.keys() == jm.pq_per_cat.keys()
    for c in tm.pq_per_cat:
        assert vars(tm[c]) == vars(jm[c])
    for isthing in (None, True, False):
        assert tm.pq_average(isthing) == jm.pq_average(isthing)
    return tm


def test_ap_perfect_predictions():
    gt = ([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.8, 0.8]], [0, 1])
    pred = gt + ([0.9, 0.8],)
    all_maps, per_class = both_ap([(pred, gt)])
    assert all_maps["all"][50] > 99
    assert all_maps["all"][95] > 99
    assert per_class["a"]["ap50"] > 99


def test_ap_false_positive_lowers_precision():
    gt = ([[0.1, 0.1, 0.3, 0.3]], [0])
    good = ([[0.1, 0.1, 0.3, 0.3]], [0], [0.9])
    fp = ([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.7, 0.7]], [0, 0], [0.5, 0.9])
    a1 = both_ap([(good, gt)])[0]["all"][50]
    a2 = both_ap([(fp, gt)])[0]["all"][50]
    assert a2 < a1


def test_ap_localization_threshold():
    gt = ([[0.1, 0.1, 0.5, 0.5]], [0])
    pred = ([[0.15, 0.15, 0.55, 0.55]], [0], [0.9])
    all_maps, _ = both_ap([(pred, gt)])
    assert all_maps["all"][50] > 99
    assert all_maps["all"][90] < 1


def _random_boxes(rng, n):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.01, 0.3, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_random_samples(seed):
    """Several images of jittered ground truth with misses, duplicates and
    false positives over three classes and every size range, with and
    without the size breakdown; an image with no prediction."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(4):
        n = rng.randint(1, 8)
        gt_boxes = _random_boxes(rng, n)
        gt_labels = rng.randint(0, 3, n)
        keep = rng.rand(n) < 0.8
        pred_boxes = np.clip(gt_boxes[keep] + rng.normal(0, 0.02, (
            int(keep.sum()), 4)), 0, 1)
        extra = rng.randint(0, 4)
        pred_boxes = np.concatenate([pred_boxes, _random_boxes(rng, extra)])
        pred_labels = np.concatenate([gt_labels[keep],
                                      rng.randint(0, 3, extra)])
        scores = rng.uniform(0.05, 1, len(pred_boxes))
        if i == 3:
            pred_boxes, pred_labels, scores = np.zeros((0, 4)), [], []
        samples.append(((pred_boxes, pred_labels, scores),
                        (gt_boxes, gt_labels)))
    both_ap(samples)
    both_ap(samples, compute_per_size_ap=False)


def test_pq_metrics():
    gt_m = np.zeros((2, 16, 16), np.float32)
    gt_m[0, :8] = 1
    gt_m[1, 8:] = 1
    gt = (gt_m, [1.0, 2.0])
    out = both_pq([(gt, gt)]).pq_average()
    assert abs(out["pq"] - 1.0) < 1e-6 and out["n"] == 2
    pred_m = np.zeros((2, 16, 16), np.float32)
    pred_m[0, :4] = 1
    pred_m[1, 8:] = 1
    assert both_pq([((pred_m, [1.0, 2.0]), gt)]).pq_average()["pq"] < 1.0
    pq3 = both_pq([(gt, gt, {1: True, 2: False})])
    assert pq3.pq_average(isthing=True)["n"] == 1
    assert pq3.pq_average(isthing=False)["n"] == 1


def test_pq_instance_level_matching():
    gt_m = np.zeros((2, 16, 16), np.float32)
    gt_m[0, :8] = 1
    gt_m[1, 8:] = 1
    pred_m = np.zeros((1, 16, 16), np.float32)
    pred_m[0, :8] = 1
    pq = both_pq([((pred_m, [1.0]), (gt_m, [1.0, 1.0]))])
    stat = pq[1]
    assert stat.tp == 1 and stat.fn == 1 and stat.fp == 0
    assert abs(pq.pq_average()["pq"] - 1.0 / 1.5) < 1e-6


def test_pq_void_rule():
    gt_m = np.zeros((1, 16, 16), np.float32)
    gt_m[0, :8] = 1
    pred_m = np.zeros((2, 16, 16), np.float32)
    pred_m[0, :8] = 1
    pred_m[1, 12:] = 1
    pq = both_pq([((pred_m, [1.0, 1.0]), (gt_m, [1.0]))])
    stat = pq[1]
    assert stat.tp == 1 and stat.fp == 0 and stat.fn == 0
    assert abs(pq.pq_average()["pq"] - 1.0) < 1e-6


def _random_masks(rng, n, hw=(24, 32)):
    m = np.zeros((n,) + hw, np.float32)
    for i in range(n):
        y0, x0 = rng.randint(0, hw[0] - 4), rng.randint(0, hw[1] - 4)
        m[i, y0:y0 + rng.randint(3, 14), x0:x0 + rng.randint(3, 18)] = 1
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pq_random_samples(seed):
    """Overlapping segments (the id map's first channel of largest value
    wins), soft ground truth thresholded at 0.5, void areas, a prediction
    with no segment, and the things/stuff split."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(4):
        n = rng.randint(1, 6)
        gt = _random_masks(rng, n)
        gt = gt * rng.choice([0.4, 1.0], n)[:, None, None]
        gt_labels = rng.randint(0, 4, n).astype(np.float32)
        pred = np.concatenate([gt[rng.rand(n) < 0.7] > 0.5,
                               _random_masks(rng, rng.randint(0, 3))]
                              ).astype(np.float32)
        pred = np.roll(pred, rng.randint(-2, 3), axis=-1)
        pred_labels = rng.randint(0, 4, len(pred)).astype(np.float32)
        if i == 3:
            pred, pred_labels = np.zeros((0, 24, 32), np.float32), []
        samples.append(((pred, pred_labels), (gt, gt_labels),
                        {0: True, 1: True, 2: False, 3: False}))
    both_pq(samples)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pq_masks_on_the_card(cuda):
    """PQMetrics builds the id maps where the masks lie; on the card the
    numbers are the CPU's."""
    rng = np.random.RandomState(3)
    gt = _random_masks(rng, 4)
    pred = np.concatenate([gt[:3], _random_masks(rng, 2)])
    labels = [[0.0, 1.0, 1.0, 2.0, 0.0], [0.0, 1.0, 1.0, 2.0]]
    results = []
    for device in ("cpu", cuda):
        m = tmetrics.PQMetrics()
        m.add_sample(mask(tsc, pred, labels[0]).to(device),
                     mask(tsc, gt, labels[1]).to(device))
        results.append(m.pq_average())
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# ApMetrics3D and DepthMetrics

def boxes3d(pkg, data, labels, scores=None, names=NAMES):
    arr = np.asarray(data, np.float32).reshape(-1, 7)
    lab = np.asarray(labels, np.float32)
    sc = None if scores is None else np.asarray(scores, np.float32)
    if pkg is tsc:
        arr, lab = torch.from_numpy(arr), torch.from_numpy(lab)
        sc = None if sc is None else torch.from_numpy(sc)
    return pkg.BoundingBoxes3D(arr, labels=pkg.Labels(lab, scores=sc,
                                                      labels_names=names))


def both_ap3d(samples, monkeypatch):
    """The port's and the JAX package's ApMetrics3D.calc_map after the same
    (pred, gt) samples of (boxes, labels[, scores]); they must be equal."""
    from torch_parity import jit_jax_pairwise
    jit_jax_pairwise(monkeypatch)
    out = []
    for pkg, metrics in ((tsc, tmetrics), (jsc, jmetrics)):
        m = metrics.ApMetrics3D()
        for pred, gt in samples:
            m.add_sample(boxes3d(pkg, *pred), boxes3d(pkg, *gt))
        out.append(m.calc_map())
    assert out[0] == out[1]
    return out[0]


def test_ap_metrics_3d(monkeypatch):
    """The replayed case of test_rotated_iou_and_3d.py: a near-perfect
    detection."""
    gt = ([[0.0, 0.0, 10.0, 2.0, 2.0, 2.0, 0.0]], [0.0])
    pred = ([[0.05, 0.0, 10.0, 2.0, 2.0, 2.0, 0.0]], [0.0], [0.9])
    maps = both_ap3d([(pred, gt)], monkeypatch)
    assert maps["all"][50] > 90


def random_scene_3d(rng, n_gt=12, n_fp=6):
    """(pred, gt): targets over 3 classes, predictions that are jittered
    copies (some with the wrong class) plus false positives, scored."""
    gt = np.concatenate([rng.uniform(-20, 20, (n_gt, 1)),
                         rng.uniform(-2, 2, (n_gt, 1)),
                         rng.uniform(5, 60, (n_gt, 1)),
                         rng.uniform(1, 5, (n_gt, 3)),
                         rng.uniform(-np.pi, np.pi, (n_gt, 1))], 1)
    gt_labels = rng.randint(0, 3, n_gt).astype(np.float32)
    jitter = gt + rng.normal(0, 0.3, gt.shape) * [1, 1, 1, .2, .2, .2, .5]
    fp = gt[rng.randint(0, n_gt, n_fp)] + rng.uniform(-6, 6, (n_fp, 7)) \
        * [1, 0, 1, 0, 0, 0, 1]
    labels = np.concatenate([np.where(rng.rand(n_gt) < 0.1,
                                      (gt_labels + 1) % 3, gt_labels),
                             rng.randint(0, 3, n_fp)]).astype(np.float32)
    pred = np.concatenate([jitter, fp])
    return ((pred, labels, rng.uniform(0, 1, len(pred))), (gt, gt_labels))


@pytest.mark.parametrize("seed", [0, 1])
def test_ap_metrics_3d_random_samples(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    maps = both_ap3d([random_scene_3d(rng) for _ in range(6)], monkeypatch)
    assert 0 < maps["all"][10] < 100 and set(maps["all"]) == {
        10, 25, 50, 70, "all"}


def depth_pair(rng, hw=(24, 32)):
    t = rng.uniform(0.5, 90.0, (1,) + hw).astype(np.float32)
    p = (t * rng.uniform(0.7, 1.4, t.shape)).astype(np.float32)
    t[0, 0, :4] = [0.0, np.inf, np.nan, 100.0]
    p[0, 1, :2] = [np.nan, np.inf]
    return p, t, (rng.uniform(0, 1, hw) > 0.2).astype(np.float32)


def test_depth_metrics_match_jax():
    """Every key within 1e-9 relative, with and without a validity mask,
    a sample without a valid pixel skipped."""
    rng = np.random.RandomState(4)
    tm, jm = tmetrics.DepthMetrics(), jmetrics.DepthMetrics()
    for i in range(3):
        p, t, mask = depth_pair(rng)
        m = mask if i else None
        tm.add_sample(tsc.Depth(torch.from_numpy(p)), torch.from_numpy(t),
                      None if m is None else torch.from_numpy(m))
        jm.add_sample(jsc.Depth(p), t, m)
    empty = np.zeros((1, 4, 4), np.float32)
    tm.add_sample(torch.from_numpy(empty), torch.from_numpy(empty))
    jm.add_sample(empty, empty)
    got, want = tm.calc_map(), jm.calc_map()
    assert len(tm) == len(jm) == 3 and got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), k
