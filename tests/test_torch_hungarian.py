"""Hungarian matching of the PyTorch port: the plain version against the JAX
package's on-device JV (``hungarian_rect``) and against scipy's
``linear_sum_assignment``, the CPU/CUDA dispatch, the CUDA wrapper's
checks and its launch plan, and, on a card, the CUDA kernel against the
plain version.

JAX is imported inside a fixture and kept on the CPU, so that on a machine
with a card this file runs without the suite's conftest:
``python -m pytest --noconftest tests/test_torch_hungarian.py``."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from aloception_tpu_torch.ops.cuda.hungarian_kernel import (
    LANE_COLUMNS, MAX_QUERIES, MAX_SMEM_BYTES, hungarian_cuda, launch_plan,
    slice_bytes)
from aloception_tpu_torch.ops.hungarian import (hungarian, hungarian_torch,
                                                jv_solve)

# the optimum must beat every other assignment by this much for the JAX and
# port solvers to be held to the same indices: the two run their float32
# potentials through different sequences (JAX pads to a square matrix), and
# a sum of 100 costs in [0, 1] carries ~6e-6 of float32 rounding
UNIQUE_MARGIN = 1e-4


@pytest.fixture(scope="module")
def jax_hungarian():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from aloception_tpu.ops import hungarian as jh
    return jh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def optimal_cost(c: np.ndarray) -> float:
    """scipy's optimum of a (targets, queries) matrix."""
    r, q = linear_sum_assignment(c)
    return float(c[r, q].astype(np.float64).sum())


def second_best_gap(c: np.ndarray) -> float:
    """How much the second-best assignment of ``c`` (targets x queries)
    costs over the best: any other assignment leaves out one pair of the
    best one, so the second best is the best with one of its pairs
    forbidden."""
    r, q = linear_sum_assignment(c)
    best = float(c[r, q].astype(np.float64).sum())
    gap = np.inf
    for i, j in zip(r, q):
        forbidden = c.astype(np.float64)
        forbidden[i, j] = 1e9
        gap = min(gap, optimal_cost(forbidden) - best)
    return gap


def total(cost: np.ndarray, matched: np.ndarray, n: int) -> float:
    """Cost of matching targets 0..n-1 to ``matched`` queries."""
    return float(cost[matched[:n], np.arange(n)].astype(np.float64).sum())


@pytest.mark.parametrize("nq,nt", [(300, 100), (100, 100), (20, 5), (7, 7)])
def test_plain_matches_jax(nq, nt, jax_hungarian):
    rng = np.random.RandomState(nq + nt)
    # uniform costs over many queries have near-optimal rivals within ulps;
    # plant one cheap query per target (overlapping the others' range, so
    # the search is not trivial) to make the optimum unique by a margin
    cost = rng.uniform(0.3, 1.0, (2, nq, nt)).astype(np.float32)
    for k in range(2):
        cost[k, rng.permutation(nq)[:nt], np.arange(nt)] = rng.uniform(
            0.0, 0.4, nt)
    n_valid = np.array([nt, max(1, nt // 2)], np.int32)
    for k in range(2):
        assert second_best_gap(cost[k, :, :n_valid[k]].T) > UNIQUE_MARGIN
    want = np.asarray(jax_hungarian.batched_hungarian_rect(cost, n_valid))
    got = hungarian_torch(torch.from_numpy(cost), torch.from_numpy(n_valid))
    assert got.dtype == torch.int32 and got.shape == (2, nt)
    for k in range(2):
        n = n_valid[k]
        np.testing.assert_array_equal(got[k, :n].numpy(), want[k, :n])
        assert (got[k, n:] == -1).all()


@pytest.mark.parametrize("nq,nt", [(300, 100), (100, 100), (20, 5), (7, 7)])
def test_plain_optimal_with_ties(nq, nt):
    """Integer costs with many ties: the total equals scipy's optimum, and
    every matched query is distinct; n_valid = 0 matches nothing."""
    rng = np.random.RandomState(nt)
    cost = rng.randint(0, 4, (4, nq, nt)).astype(np.float32)
    n_valid = np.array([nt, 0, 1, max(1, nt // 3)], np.int32)
    got = hungarian_torch(cost, n_valid).numpy()
    for k in range(4):
        n = n_valid[k]
        assert (got[k, n:] == -1).all()
        if n == 0:
            continue
        assert len(set(got[k, :n].tolist())) == n
        assert total(cost[k], got[k], n) == optimal_cost(cost[k, :, :n].T)


def test_jv_ties_go_to_the_lowest_column():
    col, steps = jv_solve(np.zeros((3, 5), np.float32))
    np.testing.assert_array_equal(col, [0, 1, 2])
    assert steps >= 3


def test_nan_costs_end():
    """A row whose costs are all NaN is left unmatched; the solve ends."""
    c = np.random.RandomState(0).rand(3, 6).astype(np.float32)
    c[1] = np.nan
    col, _ = jv_solve(c)
    assert col[1] == -1 and col[0] >= 0 and col[2] >= 0


def test_cpu_tensor_takes_plain_version():
    cost = torch.rand(3, 20, 5, generator=torch.Generator().manual_seed(0))
    n_valid = torch.tensor([5, 2, 0], dtype=torch.int32)
    before = hungarian_cuda.launches
    got = hungarian(cost, n_valid)
    assert hungarian_cuda.launches == before
    assert torch.equal(got, hungarian_torch(cost, n_valid))


@pytest.mark.parametrize("bad", ["cpu", "dtype", "n_valid_dtype", "shape",
                                 "too_many_targets"])
def test_cuda_wrapper_rejects(bad):
    cost = torch.rand(2, 20, 5)
    n_valid = torch.tensor([5, 3], dtype=torch.int32)
    err = ValueError
    if bad == "dtype":
        cost, err = cost.double(), TypeError
    elif bad == "n_valid_dtype":
        n_valid, err = n_valid.long(), TypeError
    elif bad == "shape":
        n_valid = n_valid[:1]
    elif bad == "too_many_targets":
        cost = torch.rand(2, 5, 20)
    before = hungarian_cuda.launches
    with pytest.raises(err):
        hungarian_cuda(cost, n_valid)
    assert hungarian_cuda.launches == before


# the calls the training paths launch: (M, Nq, Nt): Deformable-DETR bs8,
# DETR bs16, the multi-scale bs2 recipe, a panoptic bs4 Deformable step, the
# sample's bs2 DETR step
TRAINING_SHAPES = [(48, 300, 100), (48, 300, 7), (96, 100, 100), (12, 300, 100),
                   (24, 300, 100), (12, 100, 100)]


@pytest.mark.parametrize("shape", TRAINING_SHAPES)
def test_launch_plan_training_shapes_fit(shape):
    """Every training call is staged and fits the 227 KB of a block; a lane
    holds ceil(Nq / 32) columns or the next instance up; up to 132
    matrices take a block each."""
    M, nq, nt = shape
    plan = launch_plan(M, nq, nt)
    assert plan.staged
    assert plan.smem_bytes == plan.per_block * slice_bytes(nq, nt, True)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.lane_columns == min(k for k in LANE_COLUMNS if 32 * k >= nq)
    assert plan.per_block == 1
    assert launch_plan(M, nq, nt) is plan          # cached


def test_launch_plan_packs_matrices_past_a_wave():
    """Past one block a matrix on each of the 132 SMs, a block takes as many
    matrices as keep one wave, at most 4 and as many as fit."""
    assert launch_plan(264, 100, 100).per_block == 2
    assert launch_plan(1000, 100, 100).per_block == 4
    assert launch_plan(1000, 300, 100).per_block == 1     # 121 KB a matrix
    assert launch_plan(1000, 300, 7).per_block == 4
    assert launch_plan(264, 100, 100, n_sms=66).per_block == 4


def test_launch_plan_unstaged_and_limits():
    """(2, 1100, 60) goes unstaged (the slice is 268 KB); Nt > Nq and Nq
    above MAX_QUERIES raise."""
    plan = launch_plan(2, 1100, 60)
    assert not plan.staged and plan.lane_columns == 48
    assert plan.smem_bytes == slice_bytes(1100, 60, False)
    assert slice_bytes(1100, 60, True) > MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="Nt <= Nq"):
        launch_plan(2, 5, 20)
    with pytest.raises(ValueError, match="at most"):
        launch_plan(2, MAX_QUERIES + 1, 10)
    assert launch_plan(2, MAX_QUERIES, 10).lane_columns == MAX_QUERIES // 32


def test_slice_stride_is_odd():
    """The staged slice keeps the cost's native layout with its rows Nt | 1
    floats apart: the 32 lanes of a step, which read one target of 32
    consecutive queries, fall in 32 banks."""
    for nt in (7, 100, 64, 1):
        stride = nt | 1
        assert stride % 2 == 1 and stride >= nt
        assert len({(lane * stride) % 32 for lane in range(32)}) == 32
    assert slice_bytes(300, 100, True) == 4 * (300 * 101 + 101 + 2 * 301 + 1)
    assert slice_bytes(300, 100, False) == 4 * (101 + 2 * 301 + 1)


# (M, Nq, Nt, n_valid choices, integer costs)
CARD_CASES = {
    "deformable": (48, 300, 100, (0, 1, 7, 37, 100), False),
    "deformable_ties": (48, 300, 100, (0, 1, 7, 37, 100), True),
    "detr": (8, 100, 100, (0, 3, 100), False),
    "detr_ties": (8, 100, 100, (0, 3, 100), True),
    "odd": (5, 37, 29, (29, 1, 0), False),
    # Nq not a multiple of 32, an n = Nq square, a single target, n_valid 0
    # between others in one block (4 matrices a block past 132)
    "nq_not_32": (7, 45, 45, (45, 20, 3), False),
    "square": (3, 64, 64, (64,), False),
    "square_ties": (3, 33, 33, (33,), True),
    "single_target": (9, 300, 1, (1, 0, 1), False),
    "mixed_packed": (530, 100, 20, (0, 20, 0, 7, 1), False),
    "packed_ties": (300, 40, 40, (40, 0, 13), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(case, cuda):
    """The assignment is the plain version's exactly (the same float32
    operations in the same order); on ties the totals are scipy's."""
    M, nq, nt, choices, ties = CARD_CASES[case]
    rng = np.random.RandomState(len(case))
    cost = (rng.randint(0, 4, (M, nq, nt)) if ties
            else rng.rand(M, nq, nt)).astype(np.float32)
    n_valid = np.array([choices[k % len(choices)] for k in range(M)],
                       np.int32)
    before = hungarian_cuda.launches
    got = hungarian(torch.from_numpy(cost).to(cuda),
                    torch.from_numpy(n_valid).to(cuda))
    torch.cuda.synchronize()
    assert hungarian_cuda.launches == before + 1
    want = hungarian_torch(cost, n_valid)
    assert torch.equal(got.cpu(), want)
    if ties:
        for k in range(M):
            n = n_valid[k]
            if n:
                assert total(cost[k], got[k].cpu().numpy(), n) == \
                    optimal_cost(cost[k, :, :n].T)


@pytest.mark.cuda
def test_kernel_nan_rows_on_card(cuda):
    """Rows of NaN costs are left unmatched, NaN entries never relax a
    column, as in the plain version; the solve ends."""
    rng = np.random.RandomState(3)
    cost = rng.rand(6, 50, 12).astype(np.float32)
    cost[:, :, 4] = np.nan                      # a target no query reaches
    cost[1][rng.rand(50, 12) < 0.3] = np.nan
    cost[2, :, :] = np.nan
    n_valid = np.array([12, 12, 5, 0, 4, 12], np.int32)
    got = hungarian(torch.from_numpy(cost).to(cuda),
                    torch.from_numpy(n_valid).to(cuda)).cpu()
    want = hungarian_torch(cost, n_valid)
    assert torch.equal(got, want)
    assert (want[0, 4] == -1) and (want[2] == -1).all()


@pytest.mark.cuda
def test_kernel_negative_zero_ties_on_card(cuda):
    """-0.0 and +0.0 costs tie; the tie goes to the lowest query, as in the
    plain version."""
    cost = np.zeros((2, 40, 6), np.float32)
    cost[0, ::2] = -0.0
    cost[1] = -np.random.RandomState(0).randint(0, 2, (40, 6)).astype(
        np.float32) * 0.0
    n_valid = np.array([6, 6], np.int32)
    got = hungarian(torch.from_numpy(cost).to(cuda),
                    torch.from_numpy(n_valid).to(cuda)).cpu()
    assert torch.equal(got, hungarian_torch(cost, n_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 300, 7, (7,)), (48, 300, 100, (100,)),
                                   (96, 100, 100, (7,)),
                                   (96, 100, 100, (100,)),
                                   (12, 300, 100, (40, 13, 2, 27))])
def test_kernel_timed_shapes_on_card(shape, cuda):
    """The calls the training paths launch (``chip_smoke.HUNGARIAN_TIMED``),
    one launch each, equal to the plain version."""
    M, nq, nt, choices = shape
    rng = np.random.RandomState(M + nt)
    cost = rng.rand(M, nq, nt).astype(np.float32)
    n_valid = np.array([choices[k % len(choices)] for k in range(M)],
                       np.int32)
    before = hungarian_cuda.launches
    got = hungarian_cuda(torch.from_numpy(cost).to(cuda),
                         torch.from_numpy(n_valid).to(cuda))
    assert hungarian_cuda.launches == before + 1
    assert torch.equal(got.cpu(), hungarian_torch(cost, n_valid))


@pytest.mark.cuda
def test_kernel_on_a_side_stream(cuda):
    """The launch takes the current stream of the tensor's device."""
    rng = np.random.RandomState(4)
    cost = torch.from_numpy(rng.rand(4, 60, 10).astype(np.float32))
    n_valid = torch.tensor([10, 3, 0, 9], dtype=torch.int32)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = hungarian_cuda(cost.to(cuda), n_valid.to(cuda))
    stream.synchronize()
    assert torch.equal(got.cpu(), hungarian_torch(cost, n_valid))


@pytest.mark.cuda
def test_kernel_unstaged_on_card(cuda):
    """Columns too many for the cost slice to fit in shared memory: the
    kernel reads the cost from global memory."""
    rng = np.random.RandomState(1)
    cost = rng.rand(2, 1100, 60).astype(np.float32)
    n_valid = np.array([60, 17], np.int32)
    got = hungarian_cuda(torch.from_numpy(cost).to(cuda),
                         torch.from_numpy(n_valid).to(cuda))
    assert torch.equal(got.cpu(), hungarian_torch(cost, n_valid))
