"""Eval-path ``fused_preprocess`` of the PyTorch port against the JAX one:
/255, antialiased bilinear resize, norm_resnet."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aloception_tpu.ops.preprocess import fused_preprocess as jax_preprocess
from aloception_tpu_torch.ops.preprocess import fused_preprocess

from torch_parity import close


@pytest.mark.parametrize("in_size,out_size", [
    ((24, 32), (48, 80)),     # upsample
    ((64, 96), (40, 52)),     # downsample by non-integer ratios
    ((30, 40), (30, 40)),     # identity size
    ((30, 40), None),         # no resize
])
def test_preprocess_matches_jax(in_size, out_size):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2,) + in_size + (3,)).astype(np.uint8)
    want_x, want_m = jax_preprocess(jnp.asarray(images), out_size=out_size,
                                    dtype=jnp.float32)
    got_x, got_m = fused_preprocess(torch.from_numpy(images), out_size=out_size,
                                    dtype=torch.float32)
    close(got_x, want_x, 1e-5)
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def jax_draws(key, batch):
    """The JAX train branch's per-sample draws, as it makes them."""
    import jax
    k_flip, k_bright, k_contrast = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k_flip, 0.5, (batch, 1, 1, 1))
    bright = jax.random.uniform(k_bright, (batch, 1, 1, 1), minval=0.9,
                                maxval=1.1)
    contrast = jax.random.uniform(k_contrast, (batch, 1, 1, 1), minval=0.9,
                                  maxval=1.1)
    return tuple(torch.from_numpy(np.array(v).reshape(batch))
                 for v in (flip, bright, contrast))


@pytest.mark.parametrize("out_size", [None, (40, 52)])
def test_train_branch_matches_jax(out_size, monkeypatch):
    """Per-sample flip and brightness/contrast jitter: the port fed the JAX
    package's draws gives its output within 1e-5."""
    import jax
    from aloception_tpu_torch.ops import preprocess
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(7)
    want_x, _ = jax_preprocess(jnp.asarray(images), key, out_size=out_size,
                               train=True, dtype=jnp.float32)
    monkeypatch.setattr(preprocess, "draw_jitter",
                        lambda b, g: jax_draws(key, b))
    got_x, got_m = fused_preprocess(torch.from_numpy(images),
                                    out_size=out_size, dtype=torch.float32,
                                    train=True)
    close(got_x, want_x, 1e-5)
    assert float(got_m.abs().max()) == 0.0


def test_train_draws_come_from_the_generator():
    from aloception_tpu_torch.ops.preprocess import draw_jitter
    a = draw_jitter(64, torch.Generator().manual_seed(3))
    b = draw_jitter(64, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    flip, bright, contrast = a
    assert 0 < int(flip.sum()) < 64
    for v in (bright, contrast):
        assert float(v.min()) >= 0.9 and float(v.max()) < 1.1


def test_device_pipeline_matches_jax():
    """File paths -> the native loader ("raw") -> fused_preprocess, one
    pass (train=False), on the CPU: the JAX device_pipeline's batches."""
    from pathlib import Path
    from aloception_tpu.ops.preprocess import device_pipeline as jax_pipeline
    from aloception_tpu.runtime.loader import NativeImageLoader as JaxLoader
    from aloception_tpu_torch.ops.preprocess import device_pipeline
    from aloception_tpu_torch.runtime import NativeImageLoader
    fixtures = Path(__file__).resolve().parent / "fixtures" / "torch_coco"
    paths = sorted(str(p) for p in fixtures.glob("*.jpg")
                   if p.name != "corrupt.jpg")
    batches = [paths[:3], paths[3:6]]
    got = list(device_pipeline(batches, NativeImageLoader((48, 64), "raw"),
                               train=False, out_size=(40, 52),
                               dtype=torch.float32,
                               device=torch.device("cpu")))
    want = list(jax_pipeline(batches, JaxLoader((48, 64), "raw"),
                             train=False, out_size=(40, 52),
                             dtype=jnp.float32))
    assert len(got) == len(want) == 2
    for (gx, gm), (wx, wm) in zip(got, want):
        close(gx, wx, 1e-5)
        assert np.array_equal(gm.numpy(), np.asarray(wm))


def test_device_pipeline_raises_on_a_file_that_does_not_decode():
    """A batch holding a corrupt file raises InvalidSampleError naming it,
    instead of feeding zeros (the JAX pipeline drops the ok-mask)."""
    from pathlib import Path
    from aloception_tpu_torch.aloscene import InvalidSampleError
    from aloception_tpu_torch.ops.preprocess import device_pipeline
    from aloception_tpu_torch.runtime import NativeImageLoader
    fixtures = Path(__file__).resolve().parent / "fixtures" / "torch_coco"
    batch = [str(fixtures / "grey_375x500.jpg"), str(fixtures / "corrupt.jpg")]
    with pytest.raises(InvalidSampleError, match="corrupt.jpg"):
        next(device_pipeline([batch], NativeImageLoader((48, 64), "raw"),
                             train=False, dtype=torch.float32,
                             device=torch.device("cpu")))
