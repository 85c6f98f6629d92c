"""bfloat16 training of the PyTorch port's detectors against the JAX
package's ``dtype=bfloat16`` models on the CPU: one train step of a tiny
Deformable-DETR with box refinement and of a tiny DETR (dropout 0), the
JAX side ``jax.value_and_grad`` of the criterion (float32) on the float32
parameters of a bfloat16 model, the port's through ``TrainOptimizer(dtype=
torch.bfloat16)`` (a float32 model cast for the step, float32 masters).

A bfloat16 step is a noisy function of its inputs: through a whole model,
forward and backward, the gradients of JAX's bfloat16 step stand 15-24 %
(L2 per tensor, the median over tensors) from those of its float32 step at
these sizes, and the matcher's costs are near ties between the queries of a
tiny random model. The port rounds at other places (torch's bfloat16
kernels, its attention and bilinear sampling), so its step is a second draw
of that noise, and torch's CPU bfloat16 kernels do not repeat their sums
bit for bit from run to run. The tolerances, measured over seeds 0-2 of
both models and repeated runs before they were set (seeds 0-1 run here):
- loss and metrics: 5e-2 relative (measured up to 2.1e-2);
- ``grad_norm``: 0.15 relative (measured up to 8.3e-2);
- the gradient as a whole: its distance from JAX's bfloat16 one at most
  3x the distance of JAX's bfloat16 gradient from JAX's float32 one
  (measured 0.51-1.65x), and the distance of the port's bfloat16 gradient
  from its own float32 one between 0.3x and 3x JAX's (measured
  0.55-1.68x): the port computes in bfloat16 where JAX does, neither more
  nor less;
- matched queries: the assignments of both packages' final outputs are
  held on JAX's bfloat16 costs; where they differ, the port's total cost
  within 3e-2 of JAX's optimum (ties within bfloat16's precision; measured
  0-6 of 8 targets differ, their costs at most 9.2e-3 apart). Each seed's
  differences are printed.
The float32 masters, the cast that keeps norms and the reference-point
projection in float32, and the frozen BatchNorm buffers are checked too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu.models.deformable_detr.criterion import focal_cost_matrix
from aloception_tpu.models.detr.matcher import cost_matrix
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models import detr as tdetr
from aloception_tpu_torch.train import state as tstate
from aloception_tpu_torch.train.step import make_detr_train_step, to_float32
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax)

from test_torch_train_step import TINY, batch
from torch_parity import perturb, t

# name: (JAX model of a dtype, port model, JAX criterion, port criterion,
#        converter, JAX matcher, port matcher, JAX cost)
MODELS = {
    "deformable_refine": (
        lambda dt: jdd.DeformableDETR(with_box_refine=True,
                                      space_to_depth=False, dtype=dt, **TINY),
        lambda: tdd.DeformableDETR(with_box_refine=True, **TINY),
        jdd.deformable_criterion, tdd.deformable_criterion,
        lambda p: deformable_state_dict_from_jax(p, True),
        jdd.focal_hungarian_match, tdd.focal_hungarian_match,
        focal_cost_matrix),
    "detr": (
        lambda dt: jdetr.Detr(space_to_depth=False, dtype=dt, **TINY),
        lambda: tdetr.Detr(**TINY),
        jdetr.detr_criterion, tdetr.detr_criterion,
        detr_state_dict_from_jax, jdetr.hungarian_match,
        tdetr.hungarian_match, cost_matrix),
}


def jax_step(make, crit, params, images, mask, targets, dtype):
    """(metrics, gradients, float32 outputs) of the JAX train step's loss."""
    jm = make(dtype)

    def forward(p):
        out = jm.apply({"params": p}, images, mask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return jax.tree.map(lambda x: x.astype(jnp.float32), out)

    def loss_fn(p):
        out = forward(p)
        loss, metrics = crit(out, targets)
        return loss, (metrics, out)

    with jax.default_matmul_precision("highest"):
        (_, (metrics, out)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return metrics, jax.device_get(grads), out


def port_step(make, crit, state, images, mask, targets, dtype):
    """(metrics, the float32 gradients the update is given by name, the
    float32 outputs, the model, its optimizer)."""
    port = make()
    port.load_state_dict(state, strict=True)
    opt = tstate.TrainOptimizer(port, grad_clip=1e9, dtype=dtype)
    names = {id(p): n for n, p in port.named_parameters()}
    by_master = {id(m): names[id(p)] for p, m in zip(opt.params, opt.masters)}
    grads, outs = {}, []
    adamw_step = opt.adamw.step

    def capture(*a, **kw):
        grads.update({by_master[id(m)]: m.grad.clone() for m in opt.masters})
        return adamw_step(*a, **kw)

    opt.adamw.step = capture
    port.register_forward_hook(lambda m, i, o: outs.append(to_float32(o)))
    keys, packed = make_detr_train_step(port, opt, crit)(
        t(images), t(mask), targets)
    return dict(zip(keys, packed.tolist())), grads, outs[0], port, opt


def flat(grads, names):
    return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                           for n in names])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_train_step_matches_jax(name, seed):
    make_jax, make_port, jcrit, tcrit, convert, jmatch, tmatch, jcost = \
        MODELS[name]
    rng = np.random.RandomState(seed)
    images, mask, targets = batch(rng)
    params = perturb(jax.jit(make_jax(jnp.float32).init)(
        jax.random.PRNGKey(0), images[:1], mask[:1])["params"], rng)
    jt = {"boxes": jnp.asarray(targets["boxes"]),
          "labels": jnp.asarray(targets["labels"], jnp.int32),
          "valid": jnp.asarray(targets["valid"])}
    tt = {"boxes": t(targets["boxes"]),
          "labels": torch.from_numpy(targets["labels"]).long(),
          "valid": torch.from_numpy(targets["valid"])}
    want, jg16, jout = jax_step(make_jax, jcrit, params, images, mask, jt,
                                jnp.bfloat16)
    _, jg32, _ = jax_step(make_jax, jcrit, params, images, mask, jt,
                          jnp.float32)
    state = convert({"params": params})
    got, pg16, pout, port, opt = port_step(make_port, tcrit, state, images,
                                           mask, tt, torch.bfloat16)
    _, pg32, _, _, _ = port_step(make_port, tcrit, state, images, mask, tt,
                                 torch.float32)

    # the cast: bfloat16 compute, float32 norms, reference points, frozen BN
    dtypes = {n: p.dtype for n, p in port.named_parameters()}
    assert dtypes["class_embed.0.weight" if name != "detr"
                  else "class_embed.weight"] == torch.bfloat16
    assert all(d == torch.float32 for n, d in dtypes.items()
               if ".norm" in n or "reference_points" in n
               or "input_proj.0.1" in n)
    assert all(b.dtype == torch.float32 for n, b in port.named_buffers()
               if "bn" in n or "downsample.1" in n)
    assert all(m.dtype == torch.float32 for m in opt.masters)

    assert set(got) == set(want) | {"grad_norm"}
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= 5e-2 * max(1.0, abs(w)), (k, got[k], w)

    names = sorted(pg16)
    assert set(names) == set(n for n, p in port.named_parameters()
                             if p.requires_grad)
    jg16, jg32 = convert({"params": jg16}), convert({"params": jg32})
    p16, j16, j32, p32 = (flat(g, names) for g in (pg16, jg16, jg32, pg32))
    jax_noise = np.linalg.norm(j16 - j32)
    port_noise = np.linalg.norm(p16 - p32)
    apart = np.linalg.norm(p16 - j16)
    print(f"{name} seed {seed}: |port16 - jax16| / |jax16 - jax32| "
          f"{apart / jax_noise:.3f}, |port16 - port32| / |jax16 - jax32| "
          f"{port_noise / jax_noise:.3f}, relative to |jax16| "
          f"{apart / np.linalg.norm(j16):.3f}")
    assert apart <= 3 * jax_noise
    assert 0.3 * jax_noise <= port_noise <= 3 * jax_noise
    norm = np.linalg.norm(j16)
    assert abs(got["grad_norm"] - norm) <= 0.15 * norm

    # matched queries of the final outputs, held on JAX's bf16 costs
    valid = targets["valid"]
    jm = np.asarray(jmatch(jout, jt)[0])
    pm = tmatch(pout, tt)[0].numpy()
    differ, gap = int((jm[valid] != pm[valid]).sum()), 0.0
    for b in range(len(valid)):
        c = np.asarray(jcost(jout["pred_logits"][b], jout["pred_boxes"][b],
                             jt["labels"][b], jt["boxes"][b],
                             jt["valid"][b]))
        k = np.flatnonzero(valid[b])
        jc, pc = c[jm[b, k], k].sum(), c[pm[b, k], k].sum()
        assert len(set(pm[b, k])) == len(k)
        assert pc - jc <= 3e-2 * max(1.0, abs(jc)), (b, pc, jc)
        gap = max(gap, (pc - jc) / max(1.0, abs(jc)))
    print(f"{name} seed {seed}: {differ} of {int(valid.sum())} matched "
          f"queries differ from JAX's, their costs {gap:.2e} apart")
