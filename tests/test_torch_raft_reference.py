"""RAFT of the PyTorch port against the benchmark's plain float32 reference
(``portbench/reference/models/raft.py``: princeton-vl's ``core/`` written
out, a ``grid_sample`` lookup, no code of the port) on the CPU, at the
published widths and on the benchmark's seeded weights.

Cases: the served path (uint8 frames -> ``Frame`` -> ``norm_minmax_sym``
-> ``batch_list`` -> ``Padder`` -> ``raft(only_last)`` -> ``unpad`` ->
``inference``) on 2 pairs of 61x90 frames, padded to 64x96, after 1 and 4
steps; ``CorrPyramid.lookup`` against the reference's lookup with
coordinates inside, on the edge and outside every level, at levels smaller
than the window; the cell's comparison numbers on the program run with one
step left out; a batch of pairs against each pair alone.

Tolerances, each times max(1, max |reference flow|): 1e-5 for the served
flow (float32 convolutions in another layout and order, the lookup's
gather against ``grid_sample``'s interpolation, then up to 4 recurrent
steps; measured 9e-7 after 1 step and 8e-7 after 4); 1e-5 for the lookup
(the same samples weighed in another order); 1e-5 for a pair in a batch
against alone (the convolutions may take another algorithm for another
batch).
"""

import json
from pathlib import Path

import pytest
import torch

from aloception_tpu_torch.aloscene import Frame, batch_list
from aloception_tpu_torch.models.raft import Padder, inference, raft
from aloception_tpu_torch.ops.correlation import (CorrPyramid, corr_pyramid,
                                                  corr_volume)
from portbench import program
from portbench.reference.compare import judged
from portbench.reference.compare_flow import flow_numbers
from portbench.reference.models import raft as ref
from portbench.reference.nn import Precision
from portbench.reference.weights import make_weights

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "raft.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "limits"
                     / "raft-sintel-serve-b8.json").read_text())["numbers"]
HW = (61, 90)


def close(got, want, rtol):
    err = float((got - want).abs().max())
    assert err <= rtol * max(1.0, float(want.abs().max())), err


@pytest.fixture(scope="module")
def weights():
    return make_weights(ref.param_specs(CFG), 2**31 + 23, torch.float32,
                        "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = program.build_model(CFG, weights, torch.float32, "cpu", ref)
    assert isinstance(m, type(raft(device="cpu")))
    return m


def frames(n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, HW + (3,), generator=g, dtype=torch.uint8)
            for _ in range(n)]


def served(model, firsts, seconds, iters):
    """The port's served flow, (B, 2, H, W) from the ``Flow`` of each
    pair."""
    f1, f2 = (batch_list([Frame(x, names=("H", "W", "C")).norm_minmax_sym()
                          for x in side]).as_layout(("B", "C", "H", "W"))
              for side in (firsts, seconds))
    padder = Padder(f1.shape, mode="sintel")
    with torch.inference_mode():
        flow = padder.unpad(model(*padder.pad(f1, f2), iters=iters,
                                  only_last=True))
        return torch.stack([f.array for f in inference(flow)])


def reference(weights, firsts, seconds, iters):
    with torch.no_grad():
        return ref.flows(weights, torch.stack(firsts), torch.stack(seconds),
                         CFG, Precision(), iters)


@pytest.mark.parametrize("iters", [1, 4])
def test_served_flow_matches_reference(model, weights, iters):
    firsts, seconds = frames(2, 1), frames(2, 2)
    x = torch.randn((1, 3) + HW)
    assert torch.equal(Padder(x.shape, mode="sintel").pad(x),
                       torch.nn.functional.pad(x, ref.padding(HW)))
    got = served(model, firsts, seconds, iters)
    want = reference(weights, firsts, seconds, iters)
    assert got.shape == want.shape == (2, 2) + HW
    close(got, want, 1e-5)


def level_coords(B, H, W, g):
    """(B, 2, H, W) level-0 coordinates: inside, exactly on the edges of
    each level of a 4-level pyramid, and outside all of them."""
    xy = torch.rand(B, 2, H, W, generator=g)
    xy[:, 0] = xy[:, 0] * (W + 24) - 12
    xy[:, 1] = xy[:, 1] * (H + 24) - 12
    edges = [(0.0, 0.0), (W - 1.0, H - 1.0), (0.0, H - 1.0)]
    for lvl in range(4):
        s = 2.0 ** lvl
        edges += [((W // 2 ** lvl - 1) * s, (H // 2 ** lvl - 1) * s),
                  ((W // 2 ** lvl) * s - 0.5, -0.5 * s)]
    edges += [(-40.0, -40.0), (W + 40.0, H + 40.0), (-4.5, H + 4.25)]
    flat = xy.view(B, 2, -1)
    for i, (x, y) in enumerate(edges):
        flat[:, 0, i], flat[:, 1, i] = x, y
    return xy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_matches_grid_sample(dtype):
    """Levels 8x12, 4x6, 2x3 and 1x1: the last two smaller than the
    radius-4 window, the last one pixel (the reference's zero-padded
    case)."""
    g = torch.Generator().manual_seed(3)
    B, C, H, W = 2, 16, 8, 12
    f1, f2 = torch.randn(B, C, H, W, generator=g), \
        torch.randn(B, C, H, W, generator=g)
    levels = [lvl.to(dtype) for lvl in corr_pyramid(corr_volume(f1, f2), 4)]
    assert [tuple(lvl.shape[2:]) for lvl in levels] == \
        [(8, 12), (4, 6), (2, 3), (1, 1)]
    coords = level_coords(B, H, W, g)
    got = CorrPyramid(levels).lookup(coords, 4)
    pyramid = [lvl.float().reshape(B * H * W, 1, *lvl.shape[2:])
               for lvl in levels]
    want = ref.lookup(pyramid, coords, 4)
    assert got.shape == want.shape == (B, 4 * 81, H, W)
    close(got, want, 1e-5)
    # the windows far outside read zero in both
    assert want.view(B, 4 * 81, -1)[:, :, 11:13].abs().max() == 0


def test_numbers_flag_a_step_left_out(model, weights):
    """The cell's numbers on the served flow: within every limit with all
    the steps, over every limit with the last one left out."""
    firsts, seconds = frames(2, 4), frames(2, 5)
    want = reference(weights, firsts, seconds, 4)
    sound = flow_numbers(want, served(model, firsts, seconds, 4))
    short = flow_numbers(want, served(model, firsts, seconds, 3))
    assert judged(sound, LIMITS)["correct"]
    assert all(short[k] > LIMITS[k]["limit"] for k in LIMITS), short
    assert not judged(short, LIMITS)["correct"]


def test_a_batch_serves_each_pair_its_own_flow(model):
    firsts, seconds = frames(3, 6), frames(3, 7)
    batched = served(model, firsts, seconds, 2)
    for i in range(3):
        alone = served(model, firsts[i:i + 1], seconds[i:i + 1], 2)
        close(batched[i:i + 1], alone, 1e-5)
