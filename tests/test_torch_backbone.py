"""ResNet backbone of the PyTorch port against the flax ``Backbone``: frozen
BN, 7x7/2 stem (the JAX space-to-depth stem mapped back to it), all four
stages and the padding mask resized to each feature map."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models.backbone import Backbone as JaxBackbone
from aloception_tpu.models.backbone.resnet import conv1_to_s2d_kernel
from aloception_tpu_torch.models.backbone import Backbone
from aloception_tpu_torch.utils.weights import backbone_state_dict_from_jax

from torch_parity import close, perturb

LAYERS = ("layer1", "layer2", "layer3", "layer4")


# the space-to-depth stem needs even sizes; the 7x7 one also takes odd sizes,
# where the mask resize ratios are not integers
@pytest.mark.parametrize("space_to_depth,size", [(True, (64, 96)),
                                                 (False, (62, 90))])
def test_backbone_matches_flax(space_to_depth, size):
    rng = np.random.RandomState(0)
    H, W = size
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[0, H - 13:, :] = 1.0
    mask[1, :, W - 29:] = 1.0

    jb = JaxBackbone(return_layers=LAYERS, stage_sizes=(1, 1, 1, 1),
                     space_to_depth=space_to_depth)
    params = perturb(jb.init(jax.random.PRNGKey(0), images[:1],
                             mask[:1])["params"], rng)
    if space_to_depth:
        w7 = (rng.randn(7, 7, 3, 64) / np.sqrt(147)).astype(np.float32)
        params["trunk"]["conv1"]["kernel"] = np.asarray(conv1_to_s2d_kernel(w7))
    with jax.default_matmul_precision("highest"):
        want = jb.apply({"params": params}, jnp.asarray(images),
                        jnp.asarray(mask))

    port = Backbone(LAYERS, stage_sizes=(1, 1, 1, 1))
    port.load_state_dict(backbone_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(mask))

    assert len(got) == len(want)
    for (f, m), (fw, mw) in zip(got, want):
        close(f, fw, 1e-4)
        assert np.array_equal(m.numpy(), np.asarray(mw))
