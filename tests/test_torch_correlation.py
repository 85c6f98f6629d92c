"""RAFT's ops in the PyTorch port against the JAX package on the CPU:
``coords_grid``, ``bilinear_sample`` and ``warp`` (``ops/warp.py``), the
correlation volume, its pyramid and the radius lookup
(``ops/correlation.py``, ``CorrPyramid.lookup``). The port is NCHW, the JAX
package NHWC; inputs are drawn with numpy and the JAX side runs at HIGHEST
matmul precision.

The lookup is held against both of the JAX package's lookups, the gather
(``corr_lookup``) and the one-hot matmul recast its RAFT runs
(``corr_lookup_onehot``), with centroids outside the map, levels smaller
than the window (a 5x7 level under a 9x9 window, as at 368x496, and a 1x1
one), radius 3 and 4, and a volume whose H and W differ, on which swapping
the x-outer channel order fails. Tolerance: 1e-5 * max(1, max|ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.ops import correlation as jcorr
from aloception_tpu.ops import warp as jwarp
from aloception_tpu_torch.ops import correlation as tcorr
from aloception_tpu_torch.ops import warp as twarp

from torch_parity import close, t


def tol(ref) -> float:
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def chw(x) -> torch.Tensor:
    """A JAX (..., H, W, C) array as a port (..., C, H, W) tensor."""
    return t(np.moveaxis(np.asarray(x), -1, -3))


def test_coords_grid_matches_jax():
    got = twarp.coords_grid(5, 7)
    close(got, np.moveaxis(np.asarray(jwarp.coords_grid(5, 7)), -1, 0), 0.0)
    assert got[0, 2, 3] == 3 and got[1, 2, 3] == 2      # channels (x, y)


def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(6, 8, 3).astype(np.float32)
    x = rng.uniform(-2, 10, (4, 5)).astype(np.float32)
    y = rng.uniform(-2, 8, (4, 5)).astype(np.float32)
    x[0, :3] = [0.0, 7.0, 3.0]                          # on the grid
    y[0, :3] = [0.0, 5.0, 2.5]
    want = np.moveaxis(np.asarray(jwarp.bilinear_sample(img, x, y)), -1, 0)
    got = twarp.bilinear_sample(chw(img), t(x), t(y))
    print("bilinear_sample max|diff|",
          float(np.abs(got.numpy() - want).max()))
    close(got, want, tol(want))
    assert (got[:, (x < -1) | (x > 8)] == 0).all()      # outside: zero


def test_warp_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(9, 11, 4).astype(np.float32)
    flow = rng.uniform(-3, 3, (9, 11, 2)).astype(np.float32)
    want = jwarp.warp(img, flow)
    got = twarp.warp(chw(img), chw(flow))
    print("warp max|diff|",
          float(np.abs(got.numpy() - np.moveaxis(np.asarray(want), -1, 0))
                .max()))
    close(got, np.moveaxis(np.asarray(want), -1, 0), tol(want))
    close(twarp.warp(chw(img), torch.zeros(2, 9, 11)), chw(img), 0.0)


def fmaps(B, H, W, C, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


def test_corr_volume_matches_jax():
    f1, f2 = fmaps(2, 6, 10, 16, seed=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jcorr.corr_volume(f1, f2))
    got = tcorr.corr_volume(chw(f1), chw(f2))
    assert got.dtype == torch.float32
    print("corr_volume max|diff|", float(np.abs(got.numpy() - want).max()))
    close(got, want, tol(want))
    # bfloat16 feature maps still give a float32 volume
    assert tcorr.corr_volume(chw(f1).bfloat16(),
                             chw(f2).bfloat16()).dtype == torch.float32


def test_corr_pyramid_odd_dims_matches_jax():
    f1, f2 = fmaps(2, 7, 9, 8, seed=3)
    with jax.default_matmul_precision("highest"):
        vol = jcorr.corr_volume(f1, f2)
        want = [np.asarray(v) for v in jcorr.corr_pyramid(vol, num_levels=3)]
    got = tcorr.corr_pyramid(t(np.asarray(vol)), num_levels=3)
    assert [tuple(g.shape[2:]) for g in got] == [(7, 9), (3, 4), (1, 2)]
    for g, w in zip(got, want):
        close(g, w, tol(w))


# (fmap H, W, levels): 8x12 -> 4x6 -> 2x3; 10x14 -> 5x7 -> 2x3 -> 1x1
LOOKUP_CASES = {"8x12_3levels": (8, 12, 3), "10x14_4levels": (10, 14, 4)}


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
@pytest.mark.parametrize("ref", ["corr_lookup", "corr_lookup_onehot"])
def test_corr_lookup_matches_jax(ref, case, radius):
    H, W, levels = LOOKUP_CASES[case]
    B = 2
    f1, f2 = fmaps(B, H, W, 8, seed=4)
    coords = np.random.RandomState(5).uniform(
        -3, max(H, W) + 3, (B, H, W, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        pyr = jcorr.corr_pyramid(jcorr.corr_volume(f1, f2), levels)
        want = np.asarray(getattr(jcorr, ref)(pyr, jnp.asarray(coords),
                                              radius=radius))
    want = np.moveaxis(want, -1, 1)                     # (B, L*d*d, H, W)
    got = tcorr.CorrPyramid([t(np.asarray(p)) for p in pyr]).lookup(
        chw(coords), radius)
    err = float(np.abs(got.numpy() - want).max())
    print(f"{ref} {case} r={radius}: max|diff| {err:.3e} "
          f"(tol {tol(want):.3e})")
    close(got, want, tol(want))
    # the x offset is the outer window axis: the transposed order fails
    d = 2 * radius + 1
    swapped = got.view(B, levels, d, d, H, W).transpose(2, 3).reshape(
        got.shape)
    assert float(np.abs(swapped.numpy() - want).max()) > 100 * tol(want)


def test_corr_lookup_bfloat16_pyramid():
    """A bfloat16 pyramid (the serving path's) is read in its dtype and
    interpolated in float32: the lookup of the bfloat16-rounded volume."""
    f1, f2 = fmaps(1, 8, 12, 8, seed=6)
    coords = np.random.RandomState(7).uniform(
        -2, 14, (1, 2, 8, 12)).astype(np.float32)
    pyr = tcorr.corr_pyramid(tcorr.corr_volume(chw(f1), chw(f2)), 2)
    got = tcorr.CorrPyramid([p.bfloat16() for p in pyr]).lookup(t(coords), 2)
    want = tcorr.CorrPyramid([p.bfloat16().float() for p in pyr]).lookup(
        t(coords), 2)
    assert got.dtype == torch.float32
    close(got, want.numpy(), 0.0)
