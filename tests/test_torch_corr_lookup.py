"""RAFT's correlation lookup as the operator
``aloception_tpu_torch::corr_lookup`` (``ops/correlation.py``): on the CPU
its kernel is the plain version ``corr_lookup_torch``, with its dtype,
strides, fake tensor, export record, gradient and counters; the CUDA
wrapper's refusals, reached on the CPU; and, on a card, the hand-written
kernel (``csrc/corr_lookup.cu``) against the plain version and inside RAFT.

Imports no JAX, so on a machine with a card it runs without the suite's
conftest: ``python -m pytest --noconftest tests/test_torch_corr_lookup.py``.
The plain version is held to the JAX package in
``tests/test_torch_correlation.py``.
"""

import pytest
import torch

from aloception_tpu_torch.ops.correlation import (CorrPyramid, corr_lookup,
                                                  corr_lookup_torch,
                                                  corr_pyramid, corr_volume)
from aloception_tpu_torch.ops.cuda import corr_lookup_cuda

# (batch, query map H, W, levels, radius, coordinates' range past the map)
CASES = {
    # levels smaller than the window: 10x14 -> 5x7 -> 2x3 -> 1x1
    "small_levels_r3": (2, 10, 14, 4, 3, 3.0),
    "small_levels_r4": (2, 10, 14, 4, 4, 3.0),
    # H != W, three levels, centroids far outside the map
    "far_outside_r4": (1, 8, 12, 3, 4, 40.0),
    # a radius and level count off the instantiated ones
    "r2_two_levels": (2, 9, 7, 2, 2, 3.0),
}


def make_pyramid(B, H, W, levels, dtype=torch.float32, seed=0, device="cpu"):
    """A pyramid over the volume of two random (B, 16, H, W) feature maps."""
    g = torch.Generator(device=device).manual_seed(seed)
    f1, f2 = (torch.randn(B, 16, H, W, generator=g, device=device)
              for _ in range(2))
    return CorrPyramid([lvl.to(dtype) for lvl in
                        corr_pyramid(corr_volume(f1, f2), levels)])


def make_coords(B, H, W, past, seed=1, device="cpu"):
    """(B, 2, H, W): the pixel grid moved by a uniform flow in
    [-past, past], channels-last as RAFT keeps its coordinates."""
    g = torch.Generator(device=device).manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    grid = torch.stack([xs, ys]).float().expand(B, 2, H, W)
    flow = (torch.rand(B, 2, H, W, generator=g, device=device) * 2 - 1) * past
    return (grid + flow).contiguous(memory_format=torch.channels_last)


def case_inputs(case, dtype=torch.float32, device="cpu"):
    B, H, W, levels, radius, past = CASES[case]
    return (make_pyramid(B, H, W, levels, dtype, device=device),
            make_coords(B, H, W, past, device=device), radius)


def channels_last_strides(shape):
    B, C, H, W = shape
    return (C * H * W, 1, W * C, C)


@pytest.mark.parametrize("pyramid_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_equals_plain_version(case, pyramid_dtype):
    """On the CPU the operator is the plain version: the same float32
    samples, bit for bit, in channels-last strides."""
    pyramid, coords, radius = case_inputs(case, pyramid_dtype)
    got = pyramid.lookup(coords, radius)
    want = corr_lookup_torch(pyramid.flat, pyramid.sizes, coords, radius)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert got.stride() == channels_last_strides(got.shape)
    B, _, H, W = coords.shape
    assert got.shape == (B, len(pyramid.sizes) * (2 * radius + 1) ** 2, H, W)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfloat16_output_is_rounded_float32(case):
    """A bfloat16 output is the float32 sum rounded once to bfloat16, in
    channels-last strides."""
    pyramid, coords, radius = case_inputs(case, torch.bfloat16)
    got = pyramid.lookup(coords, radius, torch.bfloat16)
    want = pyramid.lookup(coords, radius).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert got.stride() == channels_last_strides(got.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_tensor_matches_real(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    pyramid, coords, radius = case_inputs("small_levels_r4")
    real = pyramid.lookup(coords, radius, dtype)
    with FakeTensorMode() as mode:
        flat, fcoords = (mode.from_tensor(t) for t in (pyramid.flat, coords))
        fake = corr_lookup(flat, pyramid.sizes, fcoords, radius, dtype)
    assert (fake.shape, fake.dtype, fake.stride()) == \
        (real.shape, real.dtype, real.stride())


def test_export_records_the_operator():
    class Lookup(torch.nn.Module):
        def forward(self, flat, coords):
            return corr_lookup(flat, [(10, 14), (5, 7)], coords, 3,
                               torch.bfloat16)

    flat = torch.randn(2, 140, 175)
    coords = make_coords(2, 10, 14, 3.0)
    exported = torch.export.export(Lookup(), (flat, coords), strict=False)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert "aloception_tpu_torch.corr_lookup.default" in targets
    assert torch.equal(exported.module()(flat, coords),
                       Lookup()(flat, coords))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pyramid_dtype", [torch.float32, torch.bfloat16])
def test_pyramid_gradient_is_plain_autograd(pyramid_dtype, dtype):
    """The operator's backward (the plain version recomputed) gives the
    pyramid the gradient that autograd takes through the plain version
    (and its cast to the output's dtype), exactly."""
    pyramid, coords, radius = case_inputs("small_levels_r3", pyramid_dtype)
    cotangent = torch.randn(
        pyramid.lookup(coords, radius).shape,
        generator=torch.Generator().manual_seed(2)).to(dtype)
    flat = pyramid.flat.detach().requires_grad_(True)
    corr_lookup(flat, pyramid.sizes, coords, radius, dtype).backward(
        cotangent)
    plain = flat.detach().requires_grad_(True)
    corr_lookup_torch(plain, pyramid.sizes, coords, radius).to(
        dtype).backward(cotangent)
    assert flat.grad.dtype == pyramid_dtype
    assert torch.equal(flat.grad, plain.grad)


def test_output_is_float32_or_bfloat16():
    pyramid, coords, radius = case_inputs("small_levels_r4")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pyramid.lookup(coords, radius, torch.float16)


def test_coordinates_requiring_grad_raise():
    pyramid, coords, radius = case_inputs("small_levels_r4")
    with pytest.raises(ValueError, match="no gradient"):
        pyramid.lookup(coords.requires_grad_(True), radius)
    with torch.no_grad():           # no gradient is asked for: no refusal
        pyramid.lookup(coords, radius)


def test_lookups_counted_once_a_call():
    pyramid, coords, radius = case_inputs("r2_two_levels")
    before, launches = CorrPyramid.lookups, corr_lookup_cuda.launches
    for _ in range(3):
        pyramid.lookup(coords, radius, torch.bfloat16)
    assert CorrPyramid.lookups == before + 3
    assert corr_lookup_cuda.launches == launches      # the CPU takes none


# each refusal and the words of its message
REFUSALS = {"cpu": "CUDA tensors", "dtype": "float32 or bfloat16",
            "out_dtype": "float32 or bfloat16",
            "coords_dtype": "float32 or bfloat16",
            "bf16_into_fp32": "bfloat16 only",
            "noncontiguous": "contiguous pyramid", "shape": "coords must be",
            "sizes": "do not cover", "levels": "1 to 8 levels",
            "radius": "shared memory"}


@pytest.mark.parametrize("bad", sorted(REFUSALS))
def test_cuda_wrapper_rejects(bad):
    """Every check of the wrapper, reached with CPU tensors: each input the
    kernel does not take raises its own refusal before a launch."""
    pyramid, coords, radius = case_inputs("small_levels_r4")
    flat, sizes, dtype = pyramid.flat, pyramid.sizes, torch.bfloat16
    err = ValueError
    if bad in ("dtype", "out_dtype", "coords_dtype", "bf16_into_fp32"):
        err = TypeError
        if bad == "bf16_into_fp32":
            flat, dtype = flat.bfloat16(), torch.float32
        elif bad == "dtype":
            flat = flat.double()
        elif bad == "out_dtype":
            dtype = torch.float16
        else:
            coords = coords.double()
    elif bad == "noncontiguous":
        flat = flat.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        coords = coords[:, :, :-1]
    elif bad == "sizes":
        sizes = sizes[:-1] + [(1, 2)]
    elif bad == "levels":        # 9 levels of 1x1
        flat, sizes = torch.zeros(2, 140, 9), [(1, 1)] * 9
    elif bad == "radius":        # patches past a warp's shared memory
        radius = 40
    before = corr_lookup_cuda.launches
    with pytest.raises(err, match=REFUSALS[bad]):
        corr_lookup_cuda(flat, sizes, coords, radius, dtype)
    assert corr_lookup_cuda.launches == before


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check(got, want, tag):
    """``got`` against the plain version's float32 ``want``. A float32
    output differs from it by the order of a float32 sum of four products
    only (the plain version's CUDA reduction may order them otherwise):
    1e-5 of max(1, max|want|). A bfloat16 output adds one rounding of that
    sum: a float32 sum within the first bound may round to the neighbouring
    bfloat16, so each element may be one bfloat16 step (2^-7 of its
    magnitude) apart."""
    want = want.float()
    scale = 1e-5 * max(1.0, want.abs().max().item())
    diff = (got.float() - want).abs()
    bound = scale + (2.0 ** -7 * want.abs() if got.dtype == torch.bfloat16
                     else 0.0)
    worst = (diff - bound).max().item()
    assert worst <= 0, (tag, diff.max().item())
    return diff.max().item()


# (batch, query map H, W, levels, radius, coordinates' range past the map):
# RAFT's serving cell (440x1024 at 1/8), RAFT-small at 368x496 (a 5x7 level
# under its 7x7 window), and centroids far outside the map
CARD_CASES = {
    "sintel_b8_r4": (8, 55, 128, 4, 4, 24.0),
    "small_368x496_r3": (2, 46, 62, 4, 3, 12.0),
    "far_outside_r4": (2, 46, 62, 4, 4, 400.0),
    "r2_two_levels": (2, 9, 7, 2, 2, 3.0),
}
# the dtype pairs RAFT's paths take: float32 (all flows, float32 model),
# bfloat16 (the serving path's pyramid), float32 into bfloat16 (all flows,
# bfloat16 model)
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("pyramid_dtype, dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(case, pyramid_dtype, dtype, cuda):
    B, H, W, levels, radius, past = CARD_CASES[case]
    pyramid = make_pyramid(B, H, W, levels, pyramid_dtype, device=cuda)
    coords = make_coords(B, H, W, past, device=cuda)
    before = corr_lookup_cuda.launches
    got = pyramid.lookup(coords, radius, dtype)
    torch.cuda.synchronize()
    assert corr_lookup_cuda.launches == before + 1
    assert got.dtype == dtype and got.stride() == channels_last_strides(
        got.shape)
    want = corr_lookup_torch(pyramid.flat, pyramid.sizes, coords, radius)
    print(f"{case} {pyramid_dtype} -> {dtype}: max|diff| "
          f"{_check(got, want, case):.3e}")
    # NCHW-contiguous coordinates read through their strides alike
    assert torch.equal(pyramid.lookup(coords.contiguous(), radius, dtype),
                       got)


@pytest.mark.cuda
def test_served_batch_launches_the_kernel_for_every_lookup(cuda):
    """An ``only_last`` batch of bf16 RAFT at 32 steps: every lookup is a
    launch of the kernel."""
    from aloception_tpu_torch.models.raft import raft
    model = raft(torch.bfloat16, device=cuda)
    frames = torch.rand(2, 2, 3, 128, 256, device=cuda) * 2 - 1
    lookups, launches = CorrPyramid.lookups, corr_lookup_cuda.launches
    with torch.inference_mode():
        model(frames[0], frames[1], iters=32, only_last=True)
    torch.cuda.synchronize()
    assert CorrPyramid.lookups - lookups == 32
    assert corr_lookup_cuda.launches - launches == 32


@pytest.mark.cuda
def test_bf16_raft_flow_matches_plain_path_on_card(cuda, monkeypatch):
    """A bf16 ``only_last`` RAFT forward with the kernel against the same
    forward with the plain lookup (cast to bf16, as before the kernel): the
    two differ by the lookup's float32 sum order and one bf16 rounding,
    which the 12 steps carry on. Tolerance: the gap between the plain bf16
    path and the float32 model on the same frames (``chip_smoke.py``'s
    ``raft/bf16_vs_fp32``), the deviation that serving in bf16 already
    accepts."""
    from aloception_tpu_torch.models.raft import raft
    g = torch.Generator(device=cuda).manual_seed(60)
    f1, f2 = (torch.rand(1, 3, 368, 496, generator=g, device=cuda) * 2 - 1
              for _ in range(2))
    m32 = raft(device=cuda, generator=torch.Generator(device=cuda)
               .manual_seed(61))
    m16 = raft(torch.bfloat16, device=cuda)
    m16.load_state_dict(m32.state_dict())
    with torch.inference_mode():
        kernel = m16(f1, f2, iters=12, only_last=True).float()
        launches = corr_lookup_cuda.launches
        monkeypatch.setattr(
            CorrPyramid, "lookup",
            lambda self, coords, radius, dtype=torch.float32:
            corr_lookup_torch(self.flat, self.sizes, coords, radius).to(dtype))
        plain = m16(f1, f2, iters=12, only_last=True).float()
        fp32 = m32(f1, f2, iters=12, only_last=True)
    assert corr_lookup_cuda.launches == launches
    gap = (kernel - plain).abs().max().item()
    bf16_vs_fp32 = (plain - fp32).abs().max().item()
    print(f"kernel vs plain bf16 flow max|diff| {gap:.3e}, plain bf16 vs "
          f"fp32 {bf16_vs_fp32:.3e} (max|flow| {fp32.abs().max().item():.3f})")
    assert kernel.isfinite().all()
    assert gap <= bf16_vs_fp32
