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
