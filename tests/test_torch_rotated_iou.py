"""The port's rotated and 3D IoU (``aloception_tpu_torch/ops/rotated_iou.py``)
against the JAX package's, on the CPU: the five IoU functions and
``pairwise`` on 1,200 seeded pairs and the hard cases, within 1e-5
absolute; the gradients of the summed IoU and GIoU against ``jax.grad`` on
non-degenerate pairs, within 1e-4 of max|g|; and the analytic cases of
``tests/test_rotated_iou_and_3d.py`` replayed on the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.ops import rotated_iou as jriou
from aloception_tpu_torch.ops import rotated_iou as riou

N_PAIRS = 1200
TOL = 1e-5
FUNCS_2D = ("cal_iou", "cal_giou")
FUNCS_3D = ("cal_iou_3d", "cal_giou_3d", "cal_diou_3d")


def random_boxes(rng, n, dims):
    """n boxes of ``dims`` centre coordinates in [-1, 1], sizes in [0.2, 2]
    and headings in [-pi, pi]: overlapping centres."""
    return np.concatenate([rng.uniform(-1, 1, (n, dims)),
                           rng.uniform(0.2, 2.0, (n, dims)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1
                          ).astype(np.float32)


# identical, nested, disjoint, 45 degree cross, shared edge, zero width
HARD_2D = np.array([
    [[0, 0, 1, 1, 0], [0, 0, 1, 1, 0]],
    [[0, 0, 2, 2, 0.3], [0, 0, 1, 1, 0.3]],
    [[0, 0, 1, 1, 0], [5, 5, 1, 1, 0]],
    [[0, 0, 1, 1, 0], [0, 0, 1, 1, np.pi / 4]],
    [[0, 0, 1, 1, 0], [1, 0, 1, 1, 0]],
    [[0, 0, 0, 1, 0], [0, 0, 1, 1, 0]],
], np.float32)


def hard_3d():
    """The 2D hard cases lifted to 3D (z 0, height 1), plus a vertical
    half-overlap and a vertical touch."""
    b = np.zeros((len(HARD_2D) + 2, 2, 7), np.float32)
    b[:len(HARD_2D), :, [0, 1, 3, 4, 6]] = HARD_2D
    b[:len(HARD_2D), :, 5] = 1.0
    b[-2] = [[0, 0, 0, 2, 2, 2, 0.3], [0, 0, 1, 2, 2, 2, 0.3]]
    b[-1] = [[0, 0, 0, 1, 1, 1, 0.0], [0, 0, 1, 1, 1, 1, 0.0]]
    return b


def pairs(func):
    rng = np.random.RandomState(7)
    if func in FUNCS_2D:
        rand = random_boxes(rng, 2 * N_PAIRS, 2).reshape(N_PAIRS, 2, 5)
        return rand, HARD_2D
    return random_boxes(rng, 2 * N_PAIRS, 3).reshape(N_PAIRS, 2, 7), hard_3d()


def outputs(x):
    return x if isinstance(x, tuple) else (x,)


def both(func, b):
    """(port's outputs, JAX's) of ``func`` on pairs b (n, 2, d); the JAX
    function is jitted: one compile instead of one per primitive."""
    got = outputs(getattr(riou, func)(torch.from_numpy(b[:, 0]),
                                      torch.from_numpy(b[:, 1])))
    want = outputs(jax.jit(getattr(jriou, func))(jnp.asarray(b[:, 0]),
                                                 jnp.asarray(b[:, 1])))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("func", FUNCS_2D + FUNCS_3D)
def test_iou_matches_jax(func):
    """The random pairs, then the hard cases, in one call."""
    rand, hard = pairs(func)
    got, want = both(func, np.concatenate([rand, hard]))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (len(rand) + len(hard),)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("func", ("cal_iou", "cal_giou_3d"))
def test_pairwise_matches_jax(func):
    rng = np.random.RandomState(3)
    dims = 2 if func in FUNCS_2D else 3
    b1, b2 = random_boxes(rng, 40, dims), random_boxes(rng, 30, dims)
    got = outputs(riou.pairwise(getattr(riou, func), torch.from_numpy(b1),
                                torch.from_numpy(b2)))
    want = outputs(jax.jit(lambda x, y: jriou.pairwise(
        getattr(jriou, func), x, y))(jnp.asarray(b1), jnp.asarray(b2)))
    for g, w in zip(got, want):
        assert g.shape == (40, 30)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_box2corners_and_enclosing_box_match_jax():
    rng = np.random.RandomState(4)
    b = random_boxes(rng, 200, 2).reshape(100, 2, 5)
    c1, c2 = (riou.box2corners(torch.from_numpy(b[:, i])) for i in (0, 1))

    @jax.jit
    def jax_side(x1, x2):
        j1, j2 = jriou.box2corners(x1), jriou.box2corners(x2)
        return j1, jriou.smallest_enclosing_box(j1, j2)
    j1, area = jax_side(jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]))
    np.testing.assert_allclose(c1.numpy(), np.asarray(j1), rtol=0, atol=TOL)
    np.testing.assert_allclose(riou.smallest_enclosing_box(c1, c2).numpy(),
                               np.asarray(area), rtol=0, atol=TOL)


@pytest.mark.parametrize("func", ("cal_iou", "cal_giou", "cal_iou_3d",
                                  "cal_giou_3d"))
def test_gradients_match_jax(func):
    """d(sum of the IoU or GIoU)/d(boxes) of both packages on pairs with a
    clear overlap (no vertex near another box's edge to flip a branch)."""
    rng = np.random.RandomState(11)
    dims = 2 if func in FUNCS_2D else 3
    b = random_boxes(rng, 128, dims).reshape(64, 2, -1)
    b[:, 1, :dims] = b[:, 0, :dims] + rng.uniform(-0.2, 0.2, (64, dims))

    def jax_loss(x1, x2):
        return outputs(getattr(jriou, func)(x1, x2))[0].sum()
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]))
    x1 = torch.from_numpy(b[:, 0]).requires_grad_()
    x2 = torch.from_numpy(b[:, 1]).requires_grad_()
    outputs(getattr(riou, func)(x1, x2))[0].sum().backward()
    for g, w in zip((x1.grad, x2.grad), want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


# the analytic cases of tests/test_rotated_iou_and_3d.py, on the port

def t(x):
    return torch.tensor(x, dtype=torch.float32)


def test_identical_boxes_iou_one():
    b = t([[0.0, 0.0, 2.0, 1.0, 0.3]])
    assert torch.allclose(riou.cal_iou(b, b), torch.ones(1), atol=1e-4)


def test_axis_aligned_matches_classic():
    iou = float(riou.cal_iou(t([[0.0, 0.0, 2.0, 2.0, 0.0]]),
                             t([[1.0, 0.0, 2.0, 2.0, 0.0]]))[0])
    assert abs(iou - 2 / 6) < 1e-4  # inter 2, union 6


def test_rotation_invariance():
    """Rotating both boxes by the same angle keeps the IoU."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        xy = rng.uniform(-1, 1, 2)
        b1 = np.array([[0, 0, 2, 1, 0.2]], np.float32)
        b2 = np.array([[xy[0], xy[1], 1.5, 1, -0.4]], np.float32)
        iou0 = float(riou.cal_iou(t(b1), t(b2))[0])
        for dth in (0.3, 1.1):
            c, s = np.cos(dth), np.sin(dth)

            def rot(b):
                b = b.copy()
                x, y = b[0, 0], b[0, 1]
                b[0, 0], b[0, 1] = c * x - s * y, s * x + c * y
                b[0, 4] += dth
                return b
            assert abs(iou0 - float(riou.cal_iou(t(rot(b1)),
                                                 t(rot(b2)))[0])) < 1e-3


def test_disjoint_giou_negative():
    giou, iou = riou.cal_giou(t([[0.0, 0.0, 1.0, 1.0, 0.5]]),
                              t([[5.0, 5.0, 1.0, 1.0, 1.0]]))
    assert float(iou[0]) == 0.0 and float(giou[0]) < 0.0


def test_45_degree_cross():
    """Unit squares, one turned 45 degrees, same centre: a regular octagon
    of area 2 (sqrt(2) - 1)."""
    iou = float(riou.cal_iou(t([[0.0, 0.0, 1.0, 1.0, 0.0]]),
                             t([[0.0, 0.0, 1.0, 1.0, np.pi / 4]]))[0])
    inter = 2 * (np.sqrt(2) - 1)
    assert abs(iou - inter / (2 - inter)) < 1e-3


def test_iou3d_identical_and_shifted():
    b = t([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.3]])
    assert abs(float(riou.cal_iou_3d(b, b)[0]) - 1.0) < 1e-3
    b2 = t([[0.0, 0.0, 1.0, 2.0, 2.0, 2.0, 0.3]])
    # vertical half-overlap: inter 4 * 1, union 8 + 8 - 4
    assert abs(float(riou.cal_iou_3d(b, b2)[0]) - 4 / 12) < 1e-3


def test_diou_3d_center_distance_penalty():
    diou, iou3d = riou.cal_diou_3d(t([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]]),
                                   t([[3.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]]))
    assert float(iou3d[0]) == 0.0 and float(diou[0]) < 0.0
