"""The plain reference against the program at tiny widths on the CPU:
both detectors' forwards, the criterion with its matching, the
assignment solver, and the first training steps' losses and gradients."""

import importlib
import itertools

import numpy as np
import pytest
import torch

from conftest import TINY_CONFIG, tiny
from portbench import harness
from portbench.reference import assignment, criterion
from portbench.reference.nn import Precision
from portbench.reference.weights import make_weights

CONFIGS = ("detr_r50", "deformable_detr_r50_refine")


def tiny_config(name):
    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    return dict(cfg, **TINY_CONFIG)


def arch_of(cfg):
    return importlib.import_module(
        f"portbench.reference.models.{cfg['architecture']}")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_program(name):
    from portbench import program
    cfg = tiny_config(name)
    arch = arch_of(cfg)
    w = make_weights(arch.param_specs(cfg), 5, torch.float32, "cpu")
    model = program.build_model(cfg, w, torch.float32, "cpu", arch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 96, 3, generator=g)
    mask = torch.zeros(2, 64, 96)
    mask[1, 45:], mask[1, :, 70:] = 1, 1
    with torch.no_grad():
        got = model(x, mask)
        want = arch.forward(w, x, mask, cfg, Precision())
    for out_got, out_want in zip([got] + got["aux_outputs"],
                                 [want] + want["aux_outputs"]):
        for k in ("pred_logits", "pred_boxes"):
            ref = out_want[k]
            err = (out_got[k].float() - ref).abs().max()
            assert err <= 1e-4 * max(1.0, float(ref.abs().max())), (k, err)


def test_criterion_matches_program():
    from aloception_tpu_torch.models.deformable_detr import \
        deformable_criterion
    cfg = tiny_config("deformable_detr_r50_refine")
    g = torch.Generator().manual_seed(1)

    def out():
        return {"pred_logits": torch.randn(2, 20, 91, generator=g),
                "pred_boxes": torch.rand(2, 20, 4, generator=g) * 0.5 + 0.2}
    outputs = dict(out(), aux_outputs=[out(), out()])
    targets = {"boxes": torch.rand(2, 10, 4, generator=g) * 0.4 + 0.3,
               "labels": torch.randint(0, 91, (2, 10), generator=g),
               "valid": torch.zeros(2, 10, dtype=torch.bool)}
    targets["valid"][0, :3] = True
    targets["valid"][1, :7] = True
    got, _ = deformable_criterion(outputs, targets)
    want = criterion.deformable_loss(outputs, targets, cfg["train"])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("n,m", [(1, 4), (3, 3), (4, 7), (5, 6)])
def test_assignment_is_least_cost(n, m):
    rng = np.random.default_rng(n * 10 + m)
    for _ in range(20):
        cost = rng.normal(size=(n, m))
        cols = assignment.assign(cost)
        assert len(set(cols.tolist())) == n
        best = min(cost[np.arange(n), list(p)].sum()
                   for p in itertools.permutations(range(m), n))
        assert np.isclose(cost[np.arange(n), cols].sum(), best)


def test_first_steps_match_program(bench):
    from portbench.control import readings
    from portbench.reference.compare import judged
    cell = harness.Cell(bench, "deformable-train-b8")
    r = readings(cell, 3, 0.0, control=False, device="cpu",
                 overrides=tiny("deformable-train-b8"))["program"]
    assert r["loss"] < 1e-4 and judged(r, cell.limits)["correct"], r
