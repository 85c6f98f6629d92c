"""The yardstick's frozen arithmetic on small shapes: the deformable
attention's corners, multiply-adds and bytes, the feature levels of an
input, and a forward's FLOPs."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import TINY_CONFIG
from portbench import harness
from portbench.reference import counting
from portbench.reference.weights import make_weights


def test_msda_count_by_hand():
    # one query, one head, one level of 4 x 4, two points, 3 channels:
    # one point in the middle (4 corners), one half off the left edge
    # (2 corners inside), a third with zero weight
    shapes = [(4, 4)]
    loc = torch.tensor([0.5, 0.5, 0.0, 0.5, 0.5, 0.5]).view(1, 1, 1, 1, 3, 2)
    w = torch.tensor([0.5, 0.5, 0.0]).view(1, 1, 1, 1, 3)
    assert counting.msda_fmas((1, 16, 1, 3), shapes, loc, w) == (4 + 2) * 3
    b = counting.msda_bound((1, 16, 1, 3), 4, shapes, loc, w)
    # value rows read once: the middle point's four, the edge point's
    # two at x = 0
    rows = 6
    assert b["bytes"] == (rows * 3 + loc.numel() + w.numel() + 3) * 4
    assert b["by"] == "bytes"


def test_msda_count_matches_program_formula():
    from aloception_tpu_torch.ops.ms_deform_attn import msda_fmas
    g = torch.Generator().manual_seed(0)
    shapes = [(8, 12), (4, 6), (2, 3)]
    loc = torch.rand(2, 30, 4, 3, 4, 2, generator=g) * 1.2 - 0.1
    w = torch.rand(2, 30, 4, 3, 4, generator=g)
    w[w < 0.2] = 0
    value_shape = (2, sum(h * x for h, x in shapes), 4, 8)
    flat = [s for hw in shapes for s in hw]
    assert counting.msda_fmas(value_shape, shapes, loc, w) == \
        msda_fmas(value_shape, flat, loc, w)


@pytest.mark.parametrize("hw", [(64, 96), (640, 640), (127, 201)])
def test_level_shapes_match_the_backbone(hw):
    from portbench.reference import backbone
    from portbench.reference.nn import Precision
    cfg = dict(TINY_CONFIG, frozen_bn_eps=1e-5)
    p = {k: torch.empty(s, device="meta")
         for k, s, _ in backbone.param_specs(cfg["stage_sizes"])}
    feats = backbone.resnet(torch.empty(1, *hw, 3, device="meta"), p, cfg,
                            Precision())
    got = counting.level_shapes(hw, 3)
    assert got == [tuple(feats[f"layer{i}"].shape[-2:]) for i in (2, 3, 4)]


@pytest.mark.parametrize("name", ["detr_r50", "deformable_detr_r50_refine"])
def test_forward_flops_match_a_count_of_the_program(name):
    from portbench import program
    cfg = dict(harness.read_json(harness.HERE / "configs" / f"{name}.json"),
               **TINY_CONFIG)
    arch = importlib.import_module(
        f"portbench.reference.models.{cfg['architecture']}")
    model = program.build_model(
        cfg, make_weights(arch.param_specs(cfg), 0, torch.float32, "cpu"),
        torch.float32, "cpu", arch).requires_grad_(False)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(1, 64, 96, 3), torch.zeros(1, 64, 96))
    got = counting.forward_flops(arch, cfg, (64, 96))
    # the program's operator counts only the corners that fall inside
    assert got >= counter.get_total_flops()
    assert got <= counter.get_total_flops() * 1.05
