"""MSDA core op of the PyTorch port against the JAX package: the plain
version against ``ms_deform_attn_lax`` and the Pallas kernel (interpret mode
on the CPU), the CPU/CUDA dispatch, the CUDA wrapper's checks, and, on a card,
the CUDA kernel against the plain version.

JAX is imported inside a fixture and kept on the CPU, so that on a machine
with a card this file runs without the suite's conftest, with or without JAX:
``python -m pytest --noconftest tests/test_torch_ms_deform_attn.py``."""

import numpy as np
import pytest
import torch

from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
from aloception_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_torch)

# (level shapes, Lq, nH, C, P, location range)
CASES = {
    # a level above the Pallas kernel's dense limit, a 1xN and a 2x2 level,
    # Lq not a multiple of the kernel's query tile
    "multilevel": (((16, 20), (6, 8), (1, 5), (2, 2)), 37, 2, 4, 3, (0.0, 1.0)),
    # corners outside every level
    "oob": (((16, 20), (6, 8), (1, 5), (2, 2)), 37, 2, 4, 3, (-0.2, 1.2)),
    # the model's head count and width
    "full_heads": (((8, 12), (4, 6), (2, 3), (1, 2)), 37, 8, 32, 4, (-0.2, 1.2)),
    # the tiny test model's head width
    "c16": (((1, 5), (2, 2), (3, 7)), 37, 4, 16, 4, (-0.2, 1.2)),
}


def make_inputs(case, seed=0, B=2):
    shapes, Lq, nH, C, P, (lo, hi) = CASES[case]
    rng = np.random.RandomState(seed)
    L = len(shapes)
    Len_v = sum(h * w for h, w in shapes)
    value = rng.randn(B, Len_v, nH, C).astype(np.float32)
    loc = rng.uniform(lo, hi, (B, Lq, nH, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Lq, nH, L, P)).astype(np.float32)
    w /= w.sum((3, 4), keepdims=True)
    return value, shapes, loc, w


@pytest.fixture(scope="module")
def jax_msda():
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU (interpret-mode Pallas), also where JAX
    # could see a card
    jax.config.update("jax_platforms", "cpu")
    from aloception_tpu.ops import ms_deform_attn as jax_msda
    return jax_msda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _torch(value, shapes, loc, w):
    return ms_deform_attn_torch(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc), torch.from_numpy(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_lax(case, jax_msda):
    value, shapes, loc, w = make_inputs(case)
    want = np.asarray(jax_msda.ms_deform_attn_lax(value, shapes, loc, w))
    got = _torch(value, shapes, loc, w).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("case", ["multilevel", "oob", "full_heads"])
def test_plain_matches_pallas(case, jax_msda):
    value, shapes, loc, w = make_inputs(case, seed=1)
    want = np.asarray(jax_msda.ms_deform_attn(value, shapes, loc, w,
                                              impl="pallas"))
    got = _torch(value, shapes, loc, w).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_cpu_tensor_takes_plain_version():
    value, shapes, loc, w = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else a for a in make_inputs("oob"))
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, shapes, loc, w)
    assert ms_deform_attn_cuda.launches == before
    assert torch.equal(got, ms_deform_attn_torch(value, shapes, loc, w))
    # bf16 in, bf16 out, summed in float32
    got16 = ms_deform_attn(value.bfloat16(), shapes, loc.bfloat16(),
                           w.bfloat16())
    assert got16.dtype == torch.bfloat16 and got16.shape == got.shape


@pytest.mark.parametrize("bad", ["grad", "cpu", "dtype", "shape"])
def test_cuda_wrapper_rejects(bad):
    value, shapes, loc, w = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else a for a in make_inputs("c16"))
    err = ValueError
    if bad == "grad":
        value.requires_grad_(True)
        err = NotImplementedError
    elif bad == "dtype":
        value = value.double()
        err = TypeError
    elif bad == "shape":
        shapes = shapes[:-1] + ((3, 6),)
    before = ms_deform_attn_cuda.launches
    with pytest.raises(err):
        ms_deform_attn_cuda(value, shapes, loc, w)
    assert ms_deform_attn_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, dtype, cuda):
    value, shapes, loc, w = (torch.from_numpy(a).to(cuda, dtype)
                             if isinstance(a, np.ndarray) else a
                             for a in make_inputs(case))
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 1
    want = ms_deform_attn_torch(value, shapes, loc, w)
    err = (got.float() - want.float()).abs().max().item()
    # fp32: summation order only; bf16: the output is rounded to bf16
    tol = 1e-5 if dtype == torch.float32 else \
        2e-2 * want.float().abs().max().item()
    assert err <= tol, (case, dtype, err, tol)


@pytest.mark.parametrize("fault", ["no_nvcc", "nvcc_fails"])
def test_build_failure_raises(fault, tmp_path, monkeypatch):
    """No fallback at build time: a missing or failing nvcc raises."""
    import shutil
    import torch.utils.cpp_extension
    from aloception_tpu_torch.ops.cuda import build

    (tmp_path / "probe.cu").write_text("// not compiled\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    if fault == "no_nvcc":
        monkeypatch.setattr(shutil, "which", lambda name: None)
        monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    else:
        monkeypatch.setattr(build, "_nvcc", lambda: shutil.which("false"))
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_library("probe")
    finally:
        build.load_library.cache_clear()
    assert not list((tmp_path / "_build").glob("*.so"))
