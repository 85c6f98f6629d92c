"""MSDA core op of the PyTorch port against the JAX package: the plain
version against ``ms_deform_attn_lax`` and the Pallas kernel (interpret mode
on the CPU), the CPU/CUDA dispatch, the CUDA wrapper's checks and launch
plan, and, on a card, every instance of the CUDA kernel against the plain
version.

JAX is imported inside a fixture and kept on the CPU, so that on a machine
with a card this file runs without the suite's conftest, with or without JAX:
``python -m pytest --noconftest tests/test_torch_ms_deform_attn.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
from aloception_tpu_torch.ops.cuda.ms_deform_attn_kernel import (LaunchPlan,
                                                                 launch_plan)
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
    # a head of 3 vectors (a group that is not a power of two), a 1x1 level
    "c6": (((9, 11), (1, 1), (4, 3), (2, 5)), 37, 8, 6, 4, (-0.2, 1.2)),
}
LEVELS_640 = ((80, 80), (40, 40), (20, 20), (10, 10))


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


@pytest.mark.parametrize("bad", ["grad", "cpu", "dtype", "shape", "levels"])
def test_cuda_wrapper_rejects(bad):
    value, shapes, loc, w = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else a for a in make_inputs("c16"))
    err = ValueError
    if bad == "grad":
        # the launcher has no gradient of its own (the operator's autograd
        # wraps it): an input that requires grad is refused on the CPU all
        # the same
        value.requires_grad_(True)
    elif bad == "dtype":
        value = value.double()
        err = TypeError
    elif bad == "shape":
        shapes = shapes[:-1] + ((3, 6),)
    elif bad == "levels":     # 9 levels of 1x1
        shapes = ((1, 1),) * 9
        value = torch.zeros(2, 9, 4, 16)
        loc = torch.zeros(2, 37, 4, 9, 4, 2)
        w = torch.zeros(2, 37, 4, 9, 4)
    before = ms_deform_attn_cuda.launches
    with pytest.raises(err):
        ms_deform_attn_cuda(value, shapes, loc, w)
    assert ms_deform_attn_cuda.launches == before


# launch_plan(B, Lq, nH, C, L, P, len_v, itemsize, ...): 8500 = Len_v at 640 px
BF16, FP32 = 2, 4


@pytest.mark.parametrize("itemsize, C, vec, group", [
    (BF16, 32, 16, 4),    # the model: 8 bf16 a thread, 4 threads a head
    (FP32, 32, 16, 8),
    (FP32, 4, 16, 1),     # 16 bytes: one full vector
    (BF16, 4, 8, 1),      # 8 bytes
    (FP32, 6, 8, 3),      # 24 bytes: 3 vectors of 8
    (BF16, 6, 4, 3),      # 12 bytes: 3 vectors of 4
    (FP32, 1, 4, 1),
    (BF16, 1, 2, 1),
])
def test_plan_vector_width(itemsize, C, vec, group):
    plan = launch_plan(16, 8500, 8, C, 4, 4, 8500, itemsize)
    assert plan.vec_bytes == vec
    assert C * itemsize // plan.vec_bytes == group


@pytest.mark.parametrize("itemsize, value_ptr, out_ptr, vec", [
    (BF16, 0x1008, 0, 8),
    (BF16, 0x1002, 0, 2),
    (BF16, 0, 0x1004, 4),
    (FP32, 0x1004, 0, 4),
    (BF16, 0x1001, 0, None),   # not aligned to the element: raises
    (FP32, 0x1002, 0, None),
])
def test_plan_misaligned_pointer(itemsize, value_ptr, out_ptr, vec):
    args = (16, 300, 8, 32, 4, 4, 8500, itemsize)
    if vec is None:
        with pytest.raises(ValueError, match="aligned"):
            launch_plan(*args, value_ptr=value_ptr, out_ptr=out_ptr)
    else:
        plan = launch_plan(*args, value_ptr=value_ptr, out_ptr=out_ptr)
        assert plan.vec_bytes == vec


@pytest.mark.parametrize("itemsize, B, Lq, split", [
    (BF16, 16, 300, 4),    # decoder: 38,400 triples, levels split 4 ways
    (FP32, 16, 300, 2),    # 8 threads a head already
    (BF16, 16, 8500, 1),   # encoder: many waves, no split
    (BF16, 1, 8500, 2),
    (BF16, 1, 1, 4),
])
def test_plan_level_split(itemsize, B, Lq, split):
    plan = launch_plan(B, Lq, 8, 32, 4, 4, 8500, itemsize)
    assert plan.split == split
    assert plan.unrolled


def test_plan_split_fits_levels_and_warp():
    # never more sub-groups than levels, nor more threads than a warp
    assert launch_plan(16, 300, 8, 32, 2, 4, 8500, BF16).split == 2
    assert launch_plan(16, 300, 8, 128, 4, 4, 8500, FP32).split == 1


@pytest.mark.parametrize("L, P, loc_ptr, unrolled", [
    (4, 4, 0, True),
    (3, 4, 0, False),
    (4, 3, 0, False),
    (4, 4, 0x1008, False),   # loc not on a 16-byte vector: the loop instance
])
def test_plan_instance(L, P, loc_ptr, unrolled):
    plan = launch_plan(2, 37, 8, 32, L, P, 500, BF16, loc_ptr=loc_ptr)
    assert plan.unrolled is unrolled
    assert plan.share_points is unrolled     # 4 threads a head: P of them


@pytest.mark.parametrize("itemsize, C, share", [
    (BF16, 32, True),    # 4 threads a head, one a point of each level
    (FP32, 32, True),    # 8
    (BF16, 16, False),   # 2 threads a head: each computes all its points
    (FP32, 4, False),
])
def test_plan_shares_points(itemsize, C, share):
    assert launch_plan(16, 8500, 8, C, 4, 4, 8500,
                       itemsize).share_points is share


@pytest.mark.parametrize("len_v, ok", [(2 ** 31 // 256 - 1, True),
                                       (2 ** 31 // 256, False)])
def test_plan_offset_overflow(len_v, ok):
    args = (1, 300, 8, 32, 4, 4, len_v, BF16)    # nH * C = 256
    if ok:
        assert launch_plan(*args).vec_bytes == 16
    else:
        with pytest.raises(ValueError, match="2\\*\\*31"):
            launch_plan(*args)


def test_plan_rejects_wide_heads_and_levels():
    with pytest.raises(ValueError, match="at most 32"):
        launch_plan(1, 10, 1, 512, 4, 4, 100, BF16)     # 64 vectors a head
    with pytest.raises(ValueError, match="levels"):
        launch_plan(1, 10, 1, 32, 9, 4, 100, BF16)


def _grads(fn, value, shapes, loc, w, cotangent):
    """Gradients of <fn(value, loc, w), cotangent> for value, loc and w."""
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, w)]
    out = fn(inputs[0], shapes, inputs[1], inputs[2])
    return torch.autograd.grad(out, inputs, torch.from_numpy(cotangent))


@pytest.mark.parametrize("case", ["multilevel", "oob", "full_heads"])
def test_plain_grads_match_jax(case, jax_msda):
    """Gradients of the CPU path (plain autograd) against ``jax.grad`` of
    ``ms_deform_attn_lax``, fp32: summation order and coordinate rounding
    only, so 1e-4 of each gradient's largest magnitude."""
    import jax
    value, shapes, loc, w = make_inputs(case)
    B, Lq = loc.shape[:2]
    cotangent = np.random.RandomState(7).randn(
        B, Lq, value.shape[2] * value.shape[3]).astype(np.float32)
    want = jax.grad(lambda v, l, a: (jax_msda.ms_deform_attn_lax(
        v, shapes, l, a) * cotangent).sum(), argnums=(0, 1, 2))(value, loc, w)
    got = _grads(ms_deform_attn, value, shapes, loc, w, cotangent)
    for name, g, ref in zip(("value", "loc", "w"), got, want):
        ref = np.asarray(ref)
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_function_recompute_backward_on_cpu(needs):
    """The operator ``aloception_tpu_torch::ms_deform_attn`` on the CPU,
    whose kernel there is the plain forward where the card has the CUDA
    kernel: its registered recompute backward gives plain autograd's
    gradients exactly (the same computation), None for inputs that need
    none, and counts one backward pass."""
    value, shapes, loc, w = make_inputs("c16")
    cotangent = np.random.RandomState(3).randn(
        *loc.shape[:2], value.shape[2] * value.shape[3]).astype(np.float32)
    want = _grads(ms_deform_attn_torch, value, shapes, loc, w, cotangent)
    inputs = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip((value, loc, w), needs)]
    before = ms_deform_attn_cuda.backward_passes
    out = torch.ops.aloception_tpu_torch.ms_deform_attn(
        inputs[0], [s for hw in shapes for s in hw], inputs[1], inputs[2])
    assert torch.equal(out, ms_deform_attn_torch(*(
        t.detach() for t in inputs[:1]), shapes, inputs[1].detach(),
        inputs[2].detach()))
    out.backward(torch.from_numpy(cotangent))
    assert ms_deform_attn_cuda.backward_passes == before + 1
    for t, n, g in zip(inputs, needs, want):
        if n:
            assert torch.equal(t.grad, g)
        else:
            assert t.grad is None


def _on_card(arrays, device, dtype):
    return tuple(torch.from_numpy(a).to(device, dtype)
                 if isinstance(a, np.ndarray) else a for a in arrays)


def _check(got, want, dtype, tag):
    err = (got.float() - want.float()).abs().max().item()
    # fp32: summation order only; bf16: the output is rounded to bf16
    tol = 1e-5 if dtype == torch.float32 else \
        2e-2 * want.float().abs().max().item()
    assert err <= tol, (tag, dtype, err, tol)
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, dtype, cuda):
    value, shapes, loc, w = _on_card(make_inputs(case), cuda, dtype)
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 1
    _check(got, ms_deform_attn_torch(value, shapes, loc, w), dtype, case)


# every instance of the template: (dtype, vector bytes, split, unrolled,
# points shared by shuffles); C = 8 lets every split fit a warp at every
# width, and a sub-group of at least 4 threads (P) may share points
INSTANCES = [(dt, vec, split, unrolled, share)
             for dt, vecs in ((torch.float32, (16, 8, 4)),
                              (torch.bfloat16, (16, 8, 4, 2)))
             for vec in vecs
             for split, unrolled in ((1, True), (2, True), (4, True),
                                     (1, False))
             for share in ((False, True) if unrolled and
                           8 * (4 if dt == torch.float32 else 2) // vec >= 4
                           else (False,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, vec, split, unrolled, share", INSTANCES)
def test_every_instance_on_card(dtype, vec, split, unrolled, share, cuda):
    shapes = ((16, 20), (6, 8), (1, 1), (2, 3))
    rng = np.random.RandomState(3)
    len_v = sum(h * w for h, w in shapes)
    w = rng.uniform(0, 1, (2, 37, 8, 4, 4)).astype(np.float32)
    arrays = (rng.randn(2, len_v, 8, 8).astype(np.float32), shapes,
              rng.uniform(-0.2, 1.2, (2, 37, 8, 4, 4, 2)).astype(np.float32),
              w / w.sum((3, 4), keepdims=True))
    value, shapes, loc, w = _on_card(arrays, cuda, dtype)
    plan = LaunchPlan(vec, split, unrolled, share)
    got = ms_deform_attn_cuda(value, shapes, loc, w, plan=plan)
    torch.cuda.synchronize()
    _check(got, ms_deform_attn_torch(value, shapes, loc, w), dtype, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_split_on_card(dtype, cuda):
    """The decoder site of the model at 640 px: the plan splits levels."""
    rng = np.random.RandomState(4)
    len_v = sum(h * w for h, w in LEVELS_640)
    w = rng.uniform(0, 1, (16, 300, 8, 4, 4)).astype(np.float32)
    arrays = (rng.randn(16, len_v, 8, 32).astype(np.float32), LEVELS_640,
              rng.uniform(0, 1, (16, 300, 8, 4, 4, 2)).astype(np.float32),
              w / w.sum((3, 4), keepdims=True))
    value, shapes, loc, w = _on_card(arrays, cuda, dtype)
    plan = launch_plan(16, 300, 8, 32, 4, 4, len_v, value.element_size(),
                       value.data_ptr(), loc.data_ptr(), w.data_ptr())
    assert plan.split > 1 and plan.unrolled
    got = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    err = _check(got, ms_deform_attn_torch(value, shapes, loc, w), dtype,
                 "decoder")
    # shown with -s: the fp32 margin at 640 px, where coordinates reach 80
    print(f"decoder split {plan} {dtype}: max|kernel - plain| = {err:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["shared", "own", "loop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_and_far_points_on_card(dtype, path, cuda):
    """NaN and far-outside locations add exactly 0: the kernel on them equals
    the plain version with every such point moved to (-10, -10)."""
    value, shapes, loc, w = make_inputs("full_heads", seed=5)
    loc = loc * 6 - 3                    # most points far outside
    loc.reshape(-1)[::7] = np.nan
    far = np.where(np.isnan(loc).any(-1, keepdims=True), -10.0, loc)
    value, loc, far, w = _on_card((value, loc, far, w), cuda, dtype)
    plan = launch_plan(2, 37, 8, 32, 4, 4, value.shape[1],
                       value.element_size(), value.data_ptr(),
                       loc.data_ptr(), w.data_ptr())
    assert plan.unrolled and plan.share_points
    plan = dataclasses.replace(plan, unrolled=path != "loop",
                               share_points=path == "shared")
    got = ms_deform_attn_cuda(value, shapes, loc, w, plan=plan)
    torch.cuda.synchronize()
    assert got.isfinite().all()
    _check(got, ms_deform_attn_torch(value, shapes, far, w), dtype, "nan")


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "levels", "overflow",
                                 "noncontiguous", "plan"])
def test_kernel_rejects_on_card(bad, cuda):
    """CUDA tensors the kernel cannot take raise; none reaches the plain
    version (the launch count stays)."""
    value, shapes, loc, w = _on_card(make_inputs("c16"), cuda, torch.float32)
    kwargs, err = {}, ValueError
    if bad == "dtype":
        value, loc, w = value.half(), loc.half(), w.half()
        err = TypeError
    elif bad == "levels":
        shapes = ((1, 1),) * 9
        value = torch.zeros(2, 9, 4, 16, device=cuda)
        loc = torch.zeros(2, 37, 4, 9, 4, 2, device=cuda)
        w = torch.zeros(2, 37, 4, 9, 4, device=cuda)
    elif bad == "overflow":       # one image's value of 2**31 elements
        shapes = ((1, 2 ** 31 // 256),)
        value = torch.empty(1, 2 ** 31 // 256, 8, 32, device=cuda,
                            dtype=torch.bfloat16)
        loc = torch.zeros(1, 3, 8, 1, 4, 2, device=cuda, dtype=torch.bfloat16)
        w = torch.zeros(1, 3, 8, 1, 4, device=cuda, dtype=torch.bfloat16)
    elif bad == "noncontiguous":
        loc = loc.transpose(3, 4).contiguous().transpose(3, 4)
    else:                         # a plan the kernel refuses: 3 levels unrolled
        kwargs["plan"] = LaunchPlan(16, 1, True, False)
        err = RuntimeError
    call = ms_deform_attn_cuda if kwargs else ms_deform_attn
    before = ms_deform_attn_cuda.launches
    with pytest.raises(err):
        call(value, shapes, loc, w, **kwargs)
    assert ms_deform_attn_cuda.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_heads", "oob"])
def test_function_on_card(case, cuda):
    """Inputs that require grad on the card go through the operator's
    autograd: one kernel launch forward, one backward pass, the plain
    version's gradients."""
    value, shapes, loc, w = make_inputs(case)
    cotangent = np.random.RandomState(5).randn(
        *loc.shape[:2], value.shape[2] * value.shape[3]).astype(np.float32)
    want = _grads(ms_deform_attn_torch, value, shapes, loc, w, cotangent)
    inputs = [torch.from_numpy(a).to(cuda).requires_grad_(True)
              for a in (value, loc, w)]
    launches = ms_deform_attn_cuda.launches
    passes = ms_deform_attn_cuda.backward_passes
    out = ms_deform_attn(inputs[0], shapes, inputs[1], inputs[2])
    out.backward(torch.from_numpy(cotangent).to(cuda))
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == launches + 1
    assert ms_deform_attn_cuda.backward_passes == passes + 1
    for t, g in zip(inputs, want):
        # the plain backward on the card against the CPU's: summation order
        err = (t.grad.cpu() - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item()
