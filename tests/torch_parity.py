"""Shared helpers of the ``test_torch_*`` parity tests: the JAX package on
the CPU against its PyTorch port, on inputs and parameters drawn with numpy."""

import numpy as np
import jax
import torch


def perturb(tree, rng: np.random.RandomState):
    """Numpy copy of a flax param tree with every leaf moved by noise, so that
    zero-initialised kernels (MSDA offsets and weights) and unit norms play a
    part in the comparison. Variances stay positive."""
    def move(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", None)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        std = float(x.std()) if x.size > 1 else 0.0
        return (x + 0.5 * (std or 0.05) * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, tree)


def init_like(module, rng: np.random.RandomState, *args, **kwargs):
    """Numpy variables of the shapes ``module.init(key, *args, **kwargs)``
    gives, drawn as flax's defaults draw them (LeCun-normal kernels, zero
    biases and means, unit scales and variances), without compiling the
    init: ``jax.eval_shape`` traces it only."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)

    def draw(path, s):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(s.shape, fill, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got: torch.Tensor, want, atol: float):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= atol, f"max |diff| {err} > {atol}"


def with_7x7_stem(backbone_params, rng: np.random.RandomState):
    """Give a flax space-to-depth stem the kernel of a random 7x7 one: only
    such kernels have a 7x7 form in the port."""
    from aloception_tpu.models.backbone.resnet import conv1_to_s2d_kernel
    w7 = (rng.randn(7, 7, 3, 64) / np.sqrt(147)).astype(np.float32)
    backbone_params["trunk"]["conv1"]["kernel"] = np.asarray(
        conv1_to_s2d_kernel(w7))


def jit_jax_pairwise(monkeypatch):
    """Run the JAX package's ``rotated_iou.pairwise`` jitted: one compile a
    shape instead of one per primitive (seconds on the CPU). The boxes'
    IoU methods look it up at call time."""
    from aloception_tpu.ops import rotated_iou
    monkeypatch.setattr(rotated_iou, "pairwise",
                        jax.jit(rotated_iou.pairwise, static_argnums=0))
