"""The PyTorch port stands alone: no module of ``aloception_tpu_torch``
imports jax, flax, optax, orbax, the JAX package, OpenCV (which the card
machine lacks) or scipy (the port keeps its own assignment solver), directly
or inside a function; ``chip_smoke.py`` and the multi-rank tests' rank
worker (``tests/torch_ranks.py``) import no jax, flax or JAX package (scipy
is ``chip_smoke.py``'s Hungarian oracle)."""

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


@pytest.mark.parametrize("module", [
    "ops/rotated_iou.py", "aloscene/camera_calib.py", "aloscene/points_2d.py",
    "aloscene/points_3d.py", "aloscene/oriented_boxes_2d.py",
    "aloscene/bounding_boxes_3d.py", "aloscene/depth.py",
    "aloscene/disparity.py", "aloscene/io/__init__.py",
    "aloscene/io/errors.py", "aloscene/io/flow.py",
    "aloscene/io/disparity.py", "aloscene/io/depth.py",
    "aloscene/utils/__init__.py", "aloscene/utils/flow_utils.py",
    "metrics/depth_metrics.py", "metrics/ap_metrics_3d.py"])
def test_geometry_modules_are_checked(module):
    """The 3-D geometry slice's modules are among the sources checked
    below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("module", [
    "runtime/__init__.py", "runtime/loader.py", "aloscene/io/image.py",
    "aloscene/io/mask.py", "alodataset/base_dataset.py",
    "alodataset/mixins.py", "alodataset/io_utils.py",
    "alodataset/transforms.py", "alodataset/coco_detection.py",
    "alodataset/coco_panoptic.py", "alodataset/lvis.py",
    "alodataset/merge_dataset.py", "alodataset/from_directory.py",
    "ops/preprocess.py", "train/data_modules.py", "utils/coco_fixture.py"])
def test_data_layer_modules_are_checked(module):
    """The data layer's modules (the native loader's binding, the image
    readers, the datasets and transforms, the preprocessing) are among the
    sources checked below; the loader's C++ source is the port's own."""
    assert PKG / module in SOURCES
    assert (PKG / "runtime" / "aloloader.cpp").exists()


@pytest.mark.parametrize("module", [
    "alodataset/__init__.py", "alodataset/sintel.py",
    "alodataset/flying_chairs2.py", "alodataset/flying_things.py",
    "alodataset/kitti.py", "alodataset/utils/__init__.py",
    "alodataset/utils/kitti.py", "alodataset/waymo.py",
    "alodataset/prepare/__init__.py", "alodataset/prepare/waymo_converter.py",
    "utils/flow_fixture.py", "commands/train_on_chairs.py",
    "commands/eval_on_sintel.py"])
def test_flow_kitti_waymo_modules_are_checked(module):
    """The flow, KITTI and Waymo datasets' modules, the port's own copies of
    the KITTI calibration parser and the Waymo converter, and the fixture
    writer are among the sources checked below."""
    assert PKG / module in SOURCES


@pytest.mark.parametrize("module", [
    "aloscene/renderer/__init__.py", "aloscene/renderer/renderer.py",
    "aloscene/renderer/draw.py", "aloscene/renderer/text.py",
    "aloscene/renderer/colormap.py", "alodataset/mot17.py",
    "alodataset/crowd_human.py", "alodataset/woodscape.py",
    "utils/tracking_fixture.py", "train/callbacks.py",
    "export/production/model_handler.py"])
def test_tracking_views_modules_are_checked(module):
    """The tracking and crowd datasets, the renderer, the views' drawing and
    text, the fixture writer and the callbacks are among the sources
    checked below; the glyph table the text draws from is in the port."""
    assert PKG / module in SOURCES
    assert (PKG / "aloscene" / "renderer" / "glyphs.npz").exists()


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
    "parallel/shard.py", "parallel/pipeline.py", "parallel/dryrun.py"])
def test_parallel_modules_are_checked(module):
    """The parallel package's modules are among the sources checked
    below."""
    assert PKG / module in SOURCES


def test_rank_worker_imports_no_jax():
    """What the multi-rank tests' ranks run (``tests/torch_ranks.py``)
    imports the port alone, as the card's ranks do."""
    path = ROOT / "tests" / "torch_ranks.py"
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


@pytest.mark.parametrize("child", ["points2d", "cam_intrinsic"])
def test_rotate_carries_unrotatable_children_as_jax(child):
    """``Points2D`` and ``CameraIntrinsic`` cannot rotate (their
    ``_rotate`` raises NotImplementedError); rotating a frame that holds
    one carries it over unchanged in both packages, since the recursion
    into the children skips a child whose op is not implemented."""
    import numpy as np
    import torch
    import aloception_tpu.aloscene as jsc
    import aloception_tpu_torch.aloscene as tsc
    from test_torch_aloscene import same

    def make(pkg, conv):
        f = pkg.Frame(conv(np.ones((3, 16, 24), np.float32)),
                      normalization="01")
        if child == "points2d":
            f.append_points2d(pkg.Points2D(
                conv(np.array([[0.2, 0.3]], np.float32)), "xy", False))
        else:
            f.append_cam_intrinsic(pkg.CameraIntrinsic(
                focal_length=10.0, plane_size=(16, 24)))
        return f
    jf, tf = make(jsc, lambda a: a), make(tsc, torch.from_numpy)
    with pytest.raises(NotImplementedError):
        tf.get_child(child)._rotate(5.0)
    with pytest.raises(NotImplementedError):
        jf.get_child(child)._rotate(5.0)
    same(tf.rotate(5.0).get_child(child), tf.get_child(child), atol=0)
    same(tf.rotate(5.0), jf.rotate(5.0), atol=1e-5)


def test_png_disparity_names_the_missing_decoder(tmp_path):
    from aloception_tpu_torch.aloscene import Disparity, InvalidSampleError
    from aloception_tpu_torch.aloscene.io.disparity import load_disp
    path = str(tmp_path / "disp.png")
    for load in (load_disp, Disparity):
        with pytest.raises(InvalidSampleError, match="image decoder"):
            load(path)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_chip_smoke_imports_no_jax():
    path = ROOT / "chip_smoke.py"
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(SMOKE_FORBIDDEN), roots & set(SMOKE_FORBIDDEN)
