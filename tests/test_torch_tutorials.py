"""The port's tutorials (``tutorials/torch_*.py``) run on the CPU, at the
JAX tutorials' sizes and steps, and what they print holds:

- 06: DETR's boxes for each frame, and the rendered view written;
- 08: a ``Flow`` label of the input's size, and its view written;
- 10: 8 gloo ranks (dp4 x tp2), three finite losses of the global batch,
  falling, a parameter placed over tp (half of it a rank) and 2 of the 8
  rows a rank;
- 17: 8 gloo ranks (dp4 x pp2), the pipelined forward within 1e-5 of the
  sequential stack's, a finite nonzero pipelined gradient norm.

The tutorials directory goes on ``sys.path``: the spawned ranks import the
tutorial module by its name."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TUTORIALS = Path(__file__).resolve().parents[1] / "tutorials"


@pytest.fixture
def tutorial(monkeypatch):
    monkeypatch.syspath_prepend(str(TUTORIALS))

    def load(name):
        sys.modules.pop(name, None)
        return importlib.import_module(name)
    return load


def test_06_detr_inference(tutorial, tmp_path, capsys):
    from aloception_tpu_torch.aloscene import BoundingBoxes2D
    boxes = tutorial("torch_06_detr_inference").main("cpu", str(tmp_path))
    assert len(boxes) == 2
    for b in boxes:
        assert isinstance(b, BoundingBoxes2D) and len(b) > 0
        assert torch.isfinite(b.array).all()
        assert b.get_child("labels").scores is not None
    assert (tmp_path / "alo_tutorial06.png").stat().st_size > 0
    assert "pred_logits (2, 20, 11)" in capsys.readouterr().out


def test_08_raft_optical_flow(tutorial, tmp_path, capsys):
    from aloception_tpu_torch.aloscene import Flow
    flow = tutorial("torch_08_raft_optical_flow").main("cpu", str(tmp_path))
    assert isinstance(flow, Flow) and tuple(flow.shape) == (2, 96, 128)
    assert torch.isfinite(flow.array).all()
    assert (tmp_path / "alo_tutorial08_flow.png").stat().st_size > 0
    out = capsys.readouterr().out
    assert "per-iteration predictions: 6" in out and "iter 5: EPE" in out


def test_10_multichip_sharding(tutorial):
    got = tutorial("torch_10_multichip_sharding").main("cpu")
    losses = got["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert got["placements"] == ["Shard(dim=0)"]
    assert "over ('tp',), local (256, 64) of (512, 64)" in got["placement"]
    assert "rows (2, 64, 64, 3) of the global 8" in got["batch"]


def test_17_pipeline_parallelism(tutorial):
    got = tutorial("torch_17_pipeline_parallelism").main("cpu")
    assert got["maxdiff"] <= 1e-5
    assert np.isfinite(got["grad_norm"]) and got["grad_norm"] > 0
