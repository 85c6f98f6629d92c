"""Training of the PyTorch port against the JAX package on the CPU: one train
step of a tiny Deformable-DETR with box refinement and of a tiny DETR
(dropout 0), the optimizer against the JAX package's optax chain, the
one-cycle schedule, and dropout in train mode.

The train step's loss, metrics and every trainable parameter's gradient are
held against ``jax.value_and_grad`` of the JAX train step's loss (the model
in train mode, the criterion in float32), at HIGHEST matmul precision; the
JAX gradients reach the port's parameter names through the same
``utils/weights.py`` converters as the weights (they reshape and transpose,
which are linear). The stems are plain 7x7 convolutions on both sides here:
the gradient of a space-to-depth stem kernel has taps outside the 7x7
window."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aloception_tpu.models import deformable_detr as jdd
from aloception_tpu.models import detr as jdetr
from aloception_tpu.train import state as jstate
from aloception_tpu_torch.models import deformable_detr as tdd
from aloception_tpu_torch.models import detr as tdetr
from aloception_tpu_torch.train import state as tstate
from aloception_tpu_torch.train.step import make_detr_train_step
from aloception_tpu_torch.utils.weights import (deformable_state_dict_from_jax,
                                                detr_state_dict_from_jax)

from torch_parity import perturb, t

TINY = dict(num_classes=5, hidden_dim=64, num_queries=20, nheads=4,
            num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
            stage_sizes=(1, 1, 1, 1), dropout=0.0)
H, W, NT = 64, 96, 6


def batch(rng):
    images = rng.randn(2, H, W, 3).astype(np.float32)
    mask = np.zeros((2, H, W), np.float32)
    mask[1, :, 64:] = 1.0
    valid = np.arange(NT)[None] < np.array([[3], [5]])
    boxes = np.concatenate([rng.uniform(0.2, 0.7, (2, NT, 2)),
                            rng.uniform(0.1, 0.4, (2, NT, 2))], -1)
    targets = {"boxes": (boxes * valid[..., None]).astype(np.float32),
               "labels": rng.randint(0, 5, (2, NT)) * valid, "valid": valid}
    return images, mask, targets


# name: (JAX model, port model, JAX criterion, port criterion, converter)
MODELS = {
    "deformable_refine": (
        lambda: jdd.DeformableDETR(with_box_refine=True, space_to_depth=False,
                                   **TINY),
        lambda: tdd.DeformableDETR(with_box_refine=True, **TINY),
        jdd.deformable_criterion, tdd.deformable_criterion,
        lambda p: deformable_state_dict_from_jax(p, True)),
    "detr": (
        lambda: jdetr.Detr(space_to_depth=False, **TINY),
        lambda: tdetr.Detr(**TINY),
        jdetr.detr_criterion, tdetr.detr_criterion,
        detr_state_dict_from_jax),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_matches_jax(name):
    """Loss and metrics to 1e-4 relative; each parameter's gradient to 1e-3
    of the largest gradient magnitude of its tensor (float32 sums in other
    orders through a whole model, twice: forward and backward), or 1e-6 of
    the model's largest where a tensor's gradients are near 0 (DETR's first
    decoder self-attention, whose target starts at zeros);
    ``grad_norm`` to 1e-4 relative, over the trainable parameters (frozen
    BatchNorm is made of buffers in the port and has no gradient)."""
    make_jax, make_port, jcrit, tcrit, convert = MODELS[name]
    rng = np.random.RandomState(0)
    images, mask, targets = batch(rng)
    jm = make_jax()
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), images[:1],
                                      mask[:1])["params"], rng)
    jt = {"boxes": jnp.asarray(targets["boxes"]),
          "labels": jnp.asarray(targets["labels"], jnp.int32),
          "valid": jnp.asarray(targets["valid"])}

    def loss_fn(p):
        out = jm.apply({"params": p}, images, mask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        out = jax.tree.map(lambda x: x.astype(jnp.float32), out)
        return jcrit(out, jt)

    with jax.default_matmul_precision("highest"):
        (_, want), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    want_grads = convert({"params": jax.device_get(jgrads)})

    port = make_port()
    port.load_state_dict(convert({"params": params}), strict=True)
    opt = tstate.TrainOptimizer(port, grad_clip=1e9)
    grads = {}
    adamw_step = opt.adamw.step

    def capture(*a, **kw):     # the gradients the update is given
        grads.update({n: p.grad.clone() for n, p in port.named_parameters()
                      if p.grad is not None})
        return adamw_step(*a, **kw)

    opt.adamw.step = capture
    step = make_detr_train_step(port, opt, tcrit)
    keys, packed = step(t(images), t(mask),
                        {"boxes": t(targets["boxes"]),
                         "labels": torch.from_numpy(targets["labels"]).long(),
                         "valid": torch.from_numpy(targets["valid"])})
    got = dict(zip(keys, packed.tolist()))

    assert set(got) == set(want) | {"grad_norm"}
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
    trainable = [n for n, p in port.named_parameters() if p.requires_grad]
    assert set(grads) == set(trainable)
    top = max(float(want_grads[n].abs().max()) for n in trainable)
    for n in trainable:
        ref = want_grads[n].numpy()
        err = np.abs(grads[n].numpy() - ref).max()
        assert err <= max(1e-3 * np.abs(ref).max(), 1e-6 * top), (n, err)
    norm = np.sqrt(sum(float((want_grads[n].double() ** 2).sum())
                       for n in trainable))
    assert abs(got["grad_norm"] - norm) <= 1e-4 * norm


class Tiny(torch.nn.Module):
    """Parameters named as a detector's: a backbone conv, a frozen BN (a
    buffer), a head and a frozen module."""

    def __init__(self, w):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv = torch.nn.Module()
        self.backbone.conv.weight = torch.nn.Parameter(t(w["conv"]))
        self.backbone.register_buffer("bn_scale", t(w["bn"]))
        self.head = torch.nn.Module()
        self.head.weight = torch.nn.Parameter(t(w["head"]))
        self.frozen = torch.nn.Module()
        self.frozen.weight = torch.nn.Parameter(t(w["frozen"]))


@pytest.mark.parametrize("schedule", [False, True])
def test_optimizer_matches_optax(schedule):
    """3 updates of ``TrainOptimizer`` against the JAX package's optax chain
    (``make_optimizer``) on the same gradients: AdamW in two groups (the
    backbone at lr / 10),
    clipping by global norm at 0.1 (on in the first and third update, off in
    the second), ``freeze_prefixes``, frozen BN, accumulation of 2 micro
    batches; with and without the one-cycle schedule. 1e-6 relative: the
    same float32 update in another order."""
    rng = np.random.RandomState(1)
    w = {"conv": rng.randn(3, 4), "bn": rng.randn(4), "head": rng.randn(4, 2),
         "frozen": rng.randn(2)}
    sched = dict(schedule=(tstate.onecycle_schedule(1e-3, 20) if schedule
                           else None))
    jsched = dict(schedule=(jstate.onecycle_schedule(1e-3, 20) if schedule
                            else None))
    kw = dict(lr=1e-3, lr_backbone=1e-4, weight_decay=1e-2, grad_clip=0.1,
              accumulate_steps=2, freeze_prefixes=("frozen",))
    model = Tiny(w)
    opt = tstate.TrainOptimizer(model, **kw, **sched)
    tx = jstate.make_optimizer(**kw, **jsched)
    params = {"backbone": {"conv": {"kernel": jnp.asarray(w["conv"],
                                                          jnp.float32)},
                           "bn1": {"scale": jnp.asarray(w["bn"], jnp.float32)}},
              "head": {"kernel": jnp.asarray(w["head"], jnp.float32)},
              "frozen": {"kernel": jnp.asarray(w["frozen"], jnp.float32)}}
    opt_state = tx.init(params)
    for update in range(3):
        for micro in range(2):
            scale = 1e-3 if update == 1 else 1.0    # unclipped in update 1
            g = {k: (scale * rng.randn(*v.shape)).astype(np.float32)
                 for k, v in w.items()}
            loss = sum((p * t(g[k])).sum() for k, p in (
                ("conv", model.backbone.conv.weight),
                ("head", model.head.weight), ("frozen", model.frozen.weight))
                if p.requires_grad)
            opt.backward(loss)
            opt.step()
            grads = {"backbone": {"conv": {"kernel": g["conv"]},
                                  "bn1": {"scale": g["bn"]}},
                     "head": {"kernel": g["head"]},
                     "frozen": {"kernel": g["frozen"]}}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        assert opt.updates == update + 1
        for got, want in ((model.backbone.conv.weight,
                           params["backbone"]["conv"]["kernel"]),
                          (model.backbone.bn_scale,
                           params["backbone"]["bn1"]["scale"]),
                          (model.head.weight, params["head"]["kernel"]),
                          (model.frozen.weight, params["frozen"]["kernel"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                       atol=1e-7)
    # frozen and BN never moved; the trainable ones did
    assert torch.equal(model.frozen.weight, t(w["frozen"]))
    assert torch.equal(model.backbone.bn_scale, t(w["bn"]))
    assert not torch.equal(model.head.weight, t(w["head"]))


def test_clip_is_optax():
    """``g * max / norm`` where norm >= max, else g; the norm comes back as
    a 0-d tensor."""
    rng = np.random.RandomState(2)
    for scale in (1.0, 1e-3):
        g = [t(scale * rng.randn(5, 3)), t(scale * rng.randn(7))]
        want, _ = optax.clip_by_global_norm(0.1).update(
            [np.asarray(x) for x in g], None)
        norm = tstate.clip_by_global_norm_(g, 0.1)
        assert isinstance(norm, torch.Tensor) and norm.dim() == 0
        for got, w in zip(g, want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)


def test_onecycle_schedule_matches_jax():
    port = tstate.onecycle_schedule(4e-4, 1000, pct_start=0.05)
    ref = jstate.onecycle_schedule(4e-4, 1000, pct_start=0.05)
    for s in (0, 1, 25, 49, 50, 51, 500, 999, 1000, 1500):
        # the JAX schedule computes in float32: 1e-6 of the peak
        assert port(s) == pytest.approx(float(ref(s)), rel=0, abs=4e-10)


@pytest.mark.parametrize("name", ["detr", "deformable_refine"])
def test_dropout_in_train_mode(name):
    """With dropout 0.1 each dropout zeroes about a tenth of its nonzero
    inputs and scales the others by 1 / 0.9 in train mode; the attention
    dropout is set where the JAX package has it; eval mode gives what the
    same weights give without dropout, bit for bit."""
    torch.manual_seed(0)
    kw = {**TINY, "dropout": 0.1}
    port = (tdetr.Detr(**kw) if name == "detr"
            else tdd.DeformableDETR(with_box_refine=True, **kw))
    ref = (tdetr.Detr(**TINY) if name == "detr"
           else tdd.DeformableDETR(with_box_refine=True, **TINY))
    ref.load_state_dict(port.state_dict())
    attn = [m for m in port.modules()
            if isinstance(m, torch.nn.MultiheadAttention)]
    assert attn and all(m.dropout == 0.1 for m in attn)
    stats = []

    def hook(mod, inp, out):
        x, y = inp[0].detach(), out.detach()
        kept = (x != 0) & (y != 0)
        ratio = (y[kept] / x[kept] - 1 / 0.9).abs()
        stats.append((int((x != 0).sum()), int(((x != 0) & (y == 0)).sum()),
                      float(ratio.max()) if ratio.numel() else 0.0))

    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.register_forward_hook(hook)
    rng = np.random.RandomState(3)
    images, mask = t(rng.randn(2, H, W, 3)), t(np.zeros((2, H, W)))
    port.train()
    with torch.no_grad():
        a, b = port(images, mask), port(images, mask)
    total, dropped = sum(s[0] for s in stats), sum(s[1] for s in stats)
    assert total > 20000
    assert abs(dropped / total - 0.1) < 0.01
    assert max(s[2] for s in stats) < 1e-5
    assert not torch.equal(a["pred_logits"], b["pred_logits"])
    port.eval()
    ref.eval()
    with torch.no_grad():
        got, want = port(images, mask), ref(images, mask)
    assert torch.equal(got["pred_logits"], want["pred_logits"])
    assert torch.equal(got["pred_boxes"], want["pred_boxes"])
