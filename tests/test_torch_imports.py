"""The PyTorch port stands alone: no module of ``aloception_tpu_torch``
imports jax, flax, optax, orbax, the JAX package, OpenCV (which the card
machine lacks) or scipy (the port keeps its own assignment solver), directly
or inside a function; ``chip_smoke.py`` imports no jax, flax or JAX package
(scipy is its Hungarian oracle)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "aloception_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "aloception_tpu",
             "cv2", "scipy")
SMOKE_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "aloception_tpu")
SOURCES = sorted(PKG.rglob("*.py"))


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_sources():
    assert len(SOURCES) >= 10


@pytest.mark.parametrize("module", [
    "ops/warp.py", "ops/correlation.py", "aloscene/flow.py",
    "models/raft/__init__.py", "models/raft/extractor.py",
    "models/raft/update.py", "models/raft/utils.py", "models/raft/raft.py",
    "alodataset/sintel.py", "commands/eval_on_sintel.py"])
def test_raft_modules_are_checked(module):
    """The RAFT slice's modules are among the sources checked below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("module", [
    "models/panoptic/__init__.py", "models/panoptic/panoptic_head.py",
    "metrics/__init__.py", "metrics/ap_metrics.py", "metrics/pq_metrics.py",
    "alodataset/coco_panoptic.py", "commands/eval_on_coco.py"])
def test_panoptic_modules_are_checked(module):
    """The panoptic slice's modules, the port's own copy of the metrics
    among them, are among the sources checked below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("module", [
    "train/step.py", "train/trainer.py", "train/trainers.py",
    "train/callbacks.py", "train/data_modules.py",
    "models/panoptic/criterion.py", "models/raft/criterion.py",
    "alodataset/flying_chairs2.py", "commands/train_on_coco.py",
    "commands/train_on_chairs.py"])
def test_training_modules_are_checked(module):
    """The panoptic and RAFT training slice's modules are among the sources
    checked below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("module", [
    "export/__init__.py", "export/base_exporter.py", "export/executor.py",
    "export/model_exporters.py", "export/quantization.py",
    "export/production/__init__.py", "export/production/model_handler.py",
    "commands/export_model.py"])
def test_export_modules_are_checked(module):
    """The export slice's modules are among the sources checked below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_chip_smoke_imports_no_jax():
    path = ROOT / "chip_smoke.py"
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(SMOKE_FORBIDDEN), roots & set(SMOKE_FORBIDDEN)
