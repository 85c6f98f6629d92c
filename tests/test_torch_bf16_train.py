"""bfloat16 training of the PyTorch port on the CPU, beside the JAX
package: ``TrainOptimizer``'s float32 masters against optax on float32
parameters fed the bfloat16-rounded gradients (accumulation, clipping,
frozen prefixes, a checkpoint of a bfloat16 run resumed, and loaded into a
float32 model), the MSDA operator's bfloat16 recompute backward against
``jax.vjp`` of the JAX package's ``ms_deform_attn_block`` in bfloat16, and
one bfloat16 train step of a tiny RAFT against JAX's ``dtype=bfloat16``
step.

Tolerances, measured before they were set:
- optimizer: 1e-6 relative, as the float32 optimizer's test (the same
  float32 update in another order);
- MSDA backward over seeds 0-4: the sampling locations' gradients equal
  JAX's (measured 0 difference; held at 1e-6 of their largest), the
  attention weights' within 1e-3 of their largest (measured up to 1.0e-4:
  0-2 of 6,400 entries a bfloat16 step apart, float32 sums in another
  order), the value's within 2e-2 of its largest magnitude and 1e-2 in L2
  (measured up to 1.5e-2 and 6.1e-3: JAX scatter-adds it in bfloat16, the
  port in float32); the forward within 3e-2 of max|value|
  (measured up to 1.4e-2: the port samples at float32 coordinates, JAX's
  block formulation at bfloat16 ones). The plain float32 recompute that the
  operator took before stands 26-31 % (L2) from JAX's location gradient;
- RAFT step over seeds 0-2 (0-1 run here), as the detectors' in
  ``test_torch_bf16_detr.py``: the loss and metrics 2e-2 relative
  (measured up to 3.2e-3), the gradient's distance from JAX's bfloat16 one
  at most 3x JAX's own bfloat16-float32 distance (measured 1.02-1.09x), the
  port's own between 0.3x and 3x it (measured 0.90-1.04x), the cnet's
  running statistics 1e-2 (measured up to 1.2e-3: batch statistics are
  float32 sums of bfloat16 activations)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aloception_tpu.models.raft import criterion as jcrit
from aloception_tpu.models.raft import raft as jraft
from aloception_tpu.ops.ms_deform_attn import ms_deform_attn_block
from aloception_tpu.train import state as jstate
from aloception_tpu_torch.models import raft as traft
from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from aloception_tpu_torch.train import state as tstate
from aloception_tpu_torch.train.checkpoint import CheckpointManager
from aloception_tpu_torch.utils.weights import raft_state_dict_from_jax

from test_torch_raft import TINY, nchw
from torch_parity import init_like, perturb, t


def bf16(x) -> np.ndarray:
    """x rounded to bfloat16, as float32."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


class Tiny(torch.nn.Module):
    """Parameters named as a detector's: a backbone conv, a frozen BN (a
    buffer), a head, a norm (float32 under the cast) and a frozen module."""

    def __init__(self, w):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv = torch.nn.Module()
        self.backbone.conv.weight = torch.nn.Parameter(t(w["conv"]))
        self.backbone.register_buffer("bn_scale", t(w["bn"]))
        self.head = torch.nn.Module()
        self.head.weight = torch.nn.Parameter(t(w["head"]))
        self.norm = torch.nn.LayerNorm(2)
        with torch.no_grad():
            self.norm.weight.copy_(t(w["norm"]))
        self.frozen = torch.nn.Module()
        self.frozen.weight = torch.nn.Parameter(t(w["frozen"]))

    def params(self):
        return (("conv", self.backbone.conv.weight),
                ("head", self.head.weight), ("norm", self.norm.weight),
                ("frozen", self.frozen.weight))


def jax_tree(v):
    return {"backbone": {"conv": {"kernel": v["conv"]},
                         "bn1": {"scale": v["bn"]}},
            "head": {"kernel": v["head"]}, "norm": {"scale": v["norm"]},
            "frozen": {"kernel": v["frozen"]}}


def test_masters_match_optax_on_rounded_gradients(tmp_path):
    """3 updates of a bfloat16 model through ``TrainOptimizer(dtype=
    bfloat16)`` against the JAX package's optax chain on float32 parameters
    given the bfloat16 gradients, widened: AdamW in two groups, clipping at
    0.1 (on in updates 0 and 2), accumulation of 2 micro batches, a frozen
    prefix, a frozen BN buffer, a norm kept in float32. After update 1 the
    run is saved and resumed into a fresh bfloat16 model and optimizer, and
    the checkpoint's model entry loads into a float32 model as the
    masters."""
    rng = np.random.RandomState(1)
    w = {"conv": rng.randn(3, 4), "bn": rng.randn(4), "head": rng.randn(4, 2),
         "norm": rng.randn(2), "frozen": rng.randn(2)}
    kw = dict(lr=1e-3, lr_backbone=1e-4, weight_decay=1e-2, grad_clip=0.1,
              accumulate_steps=2, freeze_prefixes=("frozen",))
    model = Tiny(w)
    opt = tstate.TrainOptimizer(model, dtype=torch.bfloat16, **kw)
    assert model.backbone.conv.weight.dtype == torch.bfloat16
    assert model.head.weight.dtype == torch.bfloat16
    assert model.norm.weight.dtype == torch.float32
    assert model.frozen.weight.dtype == torch.bfloat16
    assert {n for n, _, _ in opt.low} == {"backbone.conv.weight",
                                          "head.weight"}
    tx = jstate.make_optimizer(**kw)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jax_tree(w))
    opt_state = tx.init(params)
    for update in range(3):
        for micro in range(2):
            scale = 1e-3 if update == 1 else 1.0    # unclipped in update 1
            g = {k: bf16(scale * rng.randn(*v.shape)) for k, v in w.items()}
            loss = sum((p * t(g[k]).to(p.dtype)).sum()
                       for k, p in model.params() if p.requires_grad)
            opt.backward(loss)
            opt.step()
            # the port's backward takes loss / 2: its bfloat16 gradient is
            # the rounded one halved, exactly
            updates, opt_state = tx.update(jax_tree(g), opt_state, params)
            params = optax.apply_updates(params, updates)
        assert opt.updates == update + 1
        masters = {n: m for n, _, m in opt.low}
        for got, want in ((masters["backbone.conv.weight"],
                           params["backbone"]["conv"]["kernel"]),
                          (masters["head.weight"], params["head"]["kernel"]),
                          (model.norm.weight, params["norm"]["scale"])):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {update}")
        # what takes no update is the float32 value, rounded
        for got, want in ((model.backbone.bn_scale,
                           params["backbone"]["bn1"]["scale"]),
                          (model.frozen.weight, params["frozen"]["kernel"])):
            np.testing.assert_array_equal(got.detach().float().numpy(),
                                          bf16(want))
        # the model holds the masters rounded
        for name, p, m in opt.low:
            assert torch.equal(p, m.to(torch.bfloat16)), name
        if update == 1:
            ckpt = CheckpointManager(str(tmp_path))
            ckpt.save(2, {"model": opt.model_state_dict(model),
                          "optimizer": opt.state_dict(), "step": 2})
            saved = ckpt.restore_tree()["model"]
            assert saved["head.weight"].dtype == torch.float32
            fp32 = Tiny(w)
            fp32.load_state_dict(saved)
            assert fp32.head.weight.dtype == torch.float32
            assert torch.equal(fp32.head.weight, masters["head.weight"])
            model = Tiny({k: rng.randn(*v.shape) for k, v in w.items()})
            opt = tstate.TrainOptimizer(model, dtype=torch.bfloat16, **kw)
            assert ckpt.restore(model, opt) == 2
            assert opt.updates == 2


@pytest.mark.parametrize("seed", range(5))
def test_bf16_msda_backward_matches_jax(seed):
    """The operator's gradient of bfloat16 inputs (its recompute through
    ``ms_deform_attn_rounded``) against ``jax.vjp`` of the block formulation
    on the same bfloat16 inputs and cotangent, at 4 levels of a tiny model's
    shapes with points inside and outside them."""
    shapes = ((20, 24), (10, 12), (5, 6), (3, 3))
    B, nH, C, Lq, P = 2, 4, 8, 50, 4
    L, Lv = len(shapes), sum(h * w for h, w in shapes)
    rng = np.random.RandomState(seed)
    value = rng.randn(B, Lv, nH, C)
    loc = rng.uniform(-0.05, 1.05, (B, Lq, nH, L, P, 2))
    w = rng.dirichlet(np.ones(L * P), (B, Lq, nH)).reshape(B, Lq, nH, L, P)
    g = rng.randn(B, Lq, nH * C)
    jin = [jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
           for x in (value, loc, w, g)]
    want_out, vjp = jax.vjp(
        lambda v, l, a: ms_deform_attn_block(v, shapes, l, a), *jin[:3])
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jin[3])]
    tin = [torch.tensor(bf16(x)).bfloat16().requires_grad_()
           for x in (value, loc, w)]
    out = ms_deform_attn(tin[0], shapes, tin[1], tin[2])
    got = [x.float().numpy() for x in torch.autograd.grad(
        out, tin, torch.tensor(bf16(g)).bfloat16())]
    # the forward is the plain float32 sampling, rounded once
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want_out.astype(jnp.float32)),
                               atol=3e-2 * np.abs(bf16(value)).max())
    for k, tol in ((1, 1e-6), (2, 1e-3)):                # loc, w
        assert np.abs(got[k] - want[k]).max() <= tol * np.abs(want[k]).max()
    d = got[0] - want[0]
    assert np.abs(d).max() <= 2e-2 * np.abs(want[0]).max()
    assert np.linalg.norm(d) <= 1e-2 * np.linalg.norm(want[0])


def raft_step(variables, f1, f2, gt, valid, dtype):
    """The port's (metrics, float32 gradients by name, running statistics)
    of one train step of the tiny RAFT cast to ``dtype``."""
    port = traft.built(traft.RAFTBase(**TINY, device="cpu"), torch.float32)
    port.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    opt = tstate.TrainOptimizer(port, grad_clip=1e9, dtype=dtype)
    names = {id(p): n for n, p in port.named_parameters()}
    port.train()
    flows = port(nchw(f1), nchw(f2), iters=3)
    loss, metrics = traft.raft_sequence_loss(
        [f.float() for f in flows], nchw(gt), t(valid))
    opt.backward(loss)
    for _, p, m in opt.low:             # widen as ``step`` does
        m.grad = p.grad.float()
    grads = {names[id(p)]: m.grad.clone() if m.grad is not None
             else torch.zeros_like(m) for p, m in zip(opt.params, opt.masters)}
    stats = {n: b.clone() for n, b in port.named_buffers()
             if n.startswith("cnet.") and n.endswith(("mean", "var"))}
    return ({k: float(v.detach()) for k, v in metrics.items()}, grads, stats,
            port)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_raft_train_step_matches_jax(seed):
    """One train step of the tiny RAFT (3 iterations) in bfloat16, its
    norms and BatchNorm statistics in float32, against flax's RAFT with
    ``dtype=bfloat16``, ``deterministic=False`` and ``mutable=
    ["batch_stats"]``."""
    rng = np.random.RandomState(20 + seed)
    f0 = np.zeros((1, 64, 64, 3), np.float32)
    v = perturb(init_like(jraft.RAFTBase(**TINY), rng, f0, f0, iters=1), rng)
    f1, f2 = (rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
              for _ in range(2))
    gt = (3 * rng.randn(2, 64, 96, 2)).astype(np.float32)
    valid = (rng.rand(2, 64, 96) > 0.2).astype(np.float32)

    def jax_step(dtype):
        jm = jraft.RAFTBase(dtype=dtype, **TINY)

        def loss_fn(params):
            flows, mut = jm.apply({"params": params,
                                   "batch_stats": v["batch_stats"]}, f1, f2,
                                  iters=3, deterministic=False,
                                  mutable=["batch_stats"])
            flows = [f.astype(jnp.float32) for f in flows]
            loss, metrics = jcrit.raft_sequence_loss(flows, gt, valid)
            return loss, (metrics, mut["batch_stats"])

        with jax.default_matmul_precision("highest"):
            (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v["params"])
        sd = raft_state_dict_from_jax({"params": jax.device_get(grads),
                                       "batch_stats": jax.device_get(stats)})
        return {k: float(x) for k, x in metrics.items()}, sd

    want, j16 = jax_step(jnp.bfloat16)
    _, j32 = jax_step(jnp.float32)
    got, p16, stats, port = raft_step(v, f1, f2, gt, valid, torch.bfloat16)
    _, p32, _, _ = raft_step(v, f1, f2, gt, valid, torch.float32)

    assert port.fnet.conv1.weight.dtype == torch.bfloat16
    assert port.cnet.norm1.weight.dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in stats.values())
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-2 * max(1.0, abs(want[k])), k
    names = sorted(p16)

    def flat(grads):
        return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                               for n in names])

    a, b, c, d = flat(p16), flat(j16), flat(j32), flat(p32)
    jax_noise = np.linalg.norm(b - c)
    print(f"raft seed {seed}: |port16 - jax16| / |jax16 - jax32| "
          f"{np.linalg.norm(a - b) / jax_noise:.3f}, |port16 - port32| / "
          f"|jax16 - jax32| {np.linalg.norm(a - d) / jax_noise:.3f}")
    assert np.linalg.norm(a - b) <= 3 * jax_noise
    assert 0.3 * jax_noise <= np.linalg.norm(a - d) <= 3 * jax_noise
    worst = max(float(np.abs(s.numpy() - j16[n].numpy()).max())
                for n, s in stats.items())
    rel_metrics = max(abs(got[k] - want[k]) / max(1.0, abs(want[k]))
                      for k in want)
    print(f"raft seed {seed}: running statistics {worst:.2e} apart, "
          f"metrics {rel_metrics:.2e}")
    for n, s in stats.items():
        np.testing.assert_allclose(s.numpy(), j16[n].numpy(), atol=1e-2,
                                   err_msg=n)
