"""The port's datasets on disk against the JAX package's, on COCO-format
directories written in ``tmp_path`` from the image fixtures
(``aloception_tpu_torch/utils/coco_fixture.py``): COCO detection (with
masks, class filtering and the dropped crowd object), COCO panoptic and
LVIS ``getitem`` (images equal, boxes within 1e-6, labels and masks equal),
merge and from-directory datasets, the dataset config, the loaders' order,
the retry on an unreadable sample, a truncated image read as a sample, and
the data module's default geometry."""

import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import aloception_tpu.alodataset as jds
import aloception_tpu.alodataset.base_dataset as jbase
import aloception_tpu_torch.alodataset as tds
import aloception_tpu_torch.alodataset.base_dataset as tbase
from aloception_tpu_torch.utils.coco_fixture import (
    build_coco_dir, build_lvis_dir, build_panoptic_dir)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_coco"
JPEGS = sorted(str(p) for p in FIXTURES.glob("*.jpg") if p.name != "corrupt.jpg")


@pytest.fixture(autouse=True)
def private_config(tmp_path, monkeypatch):
    """Both packages' dataset config under the test's own directory."""
    path = str(tmp_path / "alodataset_config.json")
    monkeypatch.setattr(jbase, "CONFIG_PATH", path)
    monkeypatch.setattr(tbase, "CONFIG_PATH", path)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return build_coco_dir(str(tmp_path_factory.mktemp("coco")), JPEGS,
                          seed=1, n_train=7, n_val=3)


def same_item(got, want, masks=True):
    np.testing.assert_array_equal(got.array.numpy(),
                                  np.asarray(want.as_numpy()))
    assert got.normalization == want.normalization
    gb, wb = got.boxes2d, want.boxes2d
    assert gb.shape == tuple(wb.shape)
    np.testing.assert_allclose(gb.array.numpy(), np.asarray(wb.as_numpy()),
                               atol=1e-6, rtol=0)
    assert gb.boxes_format == wb.boxes_format and gb.absolute == wb.absolute
    np.testing.assert_array_equal(gb.labels.array.numpy(),
                                  np.asarray(wb.labels.as_numpy()))
    assert gb.labels.labels_names == wb.labels.labels_names
    if masks:
        gs, ws = got.segmentation, want.segmentation
        np.testing.assert_array_equal(gs.array.numpy(),
                                      np.asarray(ws.as_numpy()))
        np.testing.assert_array_equal(gs.labels.array.numpy(),
                                      np.asarray(ws.labels.as_numpy()))


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_coco_detection_matches_jax(coco_dir, split):
    kw = dict(dataset_dir=coco_dir, return_masks=True)
    got = tds.CocoDetectionDataset(split=getattr(tds.Split, split), **kw)
    want = jds.CocoDetectionDataset(split=getattr(jds.Split, split), **kw)
    assert got.items == want.items and got.labels_names == want.labels_names
    for i in range(len(got)):
        same_item(got.getitem(i), want.getitem(i))


def test_coco_drops_crowd_and_keeps_category_ids(coco_dir):
    """The crowd RLE object is dropped at parse time (the reference's known
    gap, kept); labels are COCO's non-contiguous ids."""
    import json
    with open(os.path.join(coco_dir, "annotations",
                           "instances_train2017.json")) as f:
        anns = json.load(f)["annotations"]
    crowd = [a for a in anns if a["iscrowd"]]
    assert len(crowd) == 1 and isinstance(crowd[0]["segmentation"], dict)
    ds = tds.CocoDetectionDataset(dataset_dir=coco_dir, return_masks=True)
    first = ds.getitem(0)
    n = sum(1 for a in anns if a["image_id"] == 1 and not a["iscrowd"])
    assert len(first.boxes2d) == n
    ids = set(int(v) for i in range(len(ds))
              for v in ds.getitem(i).boxes2d.labels.array.tolist())
    assert max(ids) > 80 and ds.labels_names[12] == "N/A"


def test_crowd_rle_rasterizes_as_jax():
    from aloception_tpu.alodataset.coco_detection import _poly_to_mask
    from aloception_tpu_torch.alodataset.coco_detection import poly_to_mask
    from aloception_tpu_torch.utils.coco_fixture import rle_of
    m = np.zeros((37, 51), np.uint8)
    m[5:20, 9:30] = 1
    m[30:, 40:] = 1
    rle = rle_of(m)
    np.testing.assert_array_equal(poly_to_mask(rle, 37, 51), m)
    np.testing.assert_array_equal(poly_to_mask(rle, 37, 51),
                                  _poly_to_mask(rle, 37, 51))


def test_coco_classes_filter_matches_jax(coco_dir):
    classes = ["person", "car", "dog", "kite", "toothbrush", "pizza"]
    kw = dict(dataset_dir=coco_dir, classes=classes, return_masks=True)
    got = tds.CocoDetectionDataset(**kw)
    want = jds.CocoDetectionDataset(**kw)
    assert got.items == want.items and got.labels_names == classes
    for i in range(len(got)):
        same_item(got.getitem(i), want.getitem(i))
        assert int(got.getitem(i).boxes2d.labels.array.max()) < len(classes)


def test_coco_panoptic_matches_jax(tmp_path):
    root = build_panoptic_dir(str(tmp_path / "pan"), JPEGS, seed=2)
    got = tds.CocoPanopticDataset(split=tds.Split.VAL, dataset_dir=root)
    want = jds.CocoPanopticDataset(split=jds.Split.VAL, dataset_dir=root)
    assert got.isthing == want.isthing and len(got) == len(want) == 4
    for i in range(len(got)):
        g, w = got.getitem(i), want.getitem(i)
        same_item(g, w)
        assert len(g.segmentation) >= 3


def test_lvis_matches_jax(tmp_path):
    root = build_lvis_dir(str(tmp_path / "lvis"), JPEGS, seed=3)
    got = tds.LvisDataset(split=tds.Split.VAL, dataset_dir=root,
                          return_masks=True)
    want = jds.LvisDataset(split=jds.Split.VAL, dataset_dir=root,
                           return_masks=True)
    for i in range(len(got)):
        same_item(got.getitem(i), want.getitem(i))


def test_merge_dataset_matches_jax(coco_dir):
    parts = []
    for pkg in (tds, jds):
        a = pkg.CocoDetectionDataset(split=pkg.Split.VAL, dataset_dir=coco_dir)
        b = pkg.CocoBaseDataset(sample=True)
        parts.append(pkg.MergeDataset([a, b], weights=[2, 1]))
    got, want = parts
    assert got.items == want.items and len(got) == 2 * 3 + 12
    for i in (0, 4, 7, 17):
        same_item(got[i], want[i], masks=False)


def test_from_directory_matches_jax(tmp_path):
    """JPEG, PNG, BMP and WebP frames equal the JAX package's; a corrupt
    file raises InvalidSampleError and ``__getitem__`` steps over it to
    ``idx + retry_offset``, as the JAX one does."""
    import cv2
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    for p in JPEGS[:3]:
        shutil.copy(p, d)
    shutil.copy(FIXTURES / "rgb_120x160.png", d / "sub")
    cv2.imwrite(str(d / "sub" / "c.bmp"), cv2.imread(JPEGS[0]))
    cv2.imwrite(str(d / "z.webp"), cv2.imread(JPEGS[1]))
    (d / "y.jpg").write_bytes(b"\xff\xd8\xff" + bytes(20))
    (d / "notes.txt").write_text("not an image")
    got = tds.FromDirectoryDataset(str(d))
    want = jds.FromDirectoryDataset(str(d))
    assert got.items == want.items and len(got) == 7
    for i, path in enumerate(got.items):
        if path.endswith("y.jpg"):
            with pytest.raises(tds.base_dataset.InvalidSampleError,
                               match="corrupt JPEG"):
                got.getitem(i)
        np.testing.assert_array_equal(got[i].array.numpy(),
                                      np.asarray(want[i].as_numpy()))


def test_dataset_dir_goes_to_the_config(coco_dir):
    tds.CocoDetectionDataset(split=tds.Split.VAL, dataset_dir=coco_dir)
    assert tbase.load_dataset_config() == {"coco": coco_dir}
    again = tds.CocoDetectionDataset(split=tds.Split.VAL)
    assert again.dataset_dir == coco_dir
    # the JAX package reads the same file
    assert jds.CocoDetectionDataset(split=jds.Split.VAL).dataset_dir \
        == coco_dir


def test_missing_dataset_dir_raises(monkeypatch):
    monkeypatch.setattr(os, "isatty", lambda fd: False)
    with pytest.raises(FileNotFoundError, match="coco"):
        tds.CocoDetectionDataset(split=tds.Split.VAL)


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_order_matches_jax(coco_dir, workers):
    """train_loader: the JAX package's shuffled order
    (RandomState(seed + epoch)) for two epochs, batches as lists;
    stream_loader: every sample in order."""
    got = tds.CocoDetectionDataset(dataset_dir=coco_dir)
    want = jds.CocoDetectionDataset(dataset_dir=coco_dir)
    tl = got.train_loader(batch_size=2, num_workers=workers, seed=5)
    jl = want.train_loader(batch_size=2, num_workers=workers, seed=5)
    assert len(tl) == len(jl) == 3
    for _ in range(2):
        for tb, jb in zip(tl, jl):
            assert len(tb) == len(jb) == 2
            for g, w in zip(tb, jb):
                same_item(g, w, masks=False)
    stream = list(got.stream_loader(num_workers=workers))
    assert len(stream) == len(got)
    for i, f in enumerate(stream):
        same_item(f, want.getitem(i), masks=False)


def test_retry_steps_over_an_unreadable_image(coco_dir, tmp_path):
    """An image that does not decode: both packages retry at
    idx + retry_offset, and raise after max_retry_on_error retries."""
    root = str(tmp_path / "coco")
    shutil.copytree(coco_dir, root)
    name = sorted(os.listdir(os.path.join(root, "val2017")))[1]
    shutil.copy(FIXTURES / "corrupt.jpg", os.path.join(root, "val2017", name))
    kw = dict(split=tds.Split.VAL, dataset_dir=root, retry_offset=1)
    got = tds.CocoDetectionDataset(**kw)
    want = jds.CocoDetectionDataset(**{**kw, "split": jds.Split.VAL})
    with pytest.raises(tds.base_dataset.InvalidSampleError):
        got.getitem(1)
    same_item(got[1], want.getitem(2), masks=False)
    same_item(got[1], want[1], masks=False)
    bad = tds.CocoDetectionDataset(split=tds.Split.VAL, dataset_dir=root,
                                   retry_offset=0, max_retry_on_error=2)
    with pytest.raises(tds.base_dataset.InvalidSampleError):
        bad[1]


def test_truncated_image_is_a_sample_as_in_jax(coco_dir, tmp_path):
    """A JPEG cut short is read as cv2 reads it, so both packages return
    the same sample and neither retries."""
    root = str(tmp_path / "coco")
    shutil.copytree(coco_dir, root)
    name = sorted(os.listdir(os.path.join(root, "val2017")))[1]
    data = (FIXTURES / "progressive_427x640.jpg").read_bytes()
    with open(os.path.join(root, "val2017", name), "wb") as f:
        f.write(data[:len(data) // 2])
    kw = dict(split=tds.Split.VAL, dataset_dir=root, retry_offset=1)
    got = tds.CocoDetectionDataset(**kw)
    want = jds.CocoDetectionDataset(**{**kw, "split": jds.Split.VAL})
    same_item(got.getitem(1), want.getitem(1), masks=False)
    same_item(got[1], want[1], masks=False)


def test_coco_detection2detr_defaults_to_multiscale():
    """``CocoDetection2Detr()`` takes the JAX default, the multi-scale
    geometry (``size=None``): the same transforms as the JAX module's."""
    from aloception_tpu.train import CocoDetection2Detr as JaxDM
    from aloception_tpu_torch.train import CocoDetection2Detr
    got, want = CocoDetection2Detr(sample=True), JaxDM(sample=True)
    assert got.size is None and want.size is None

    def names(compose):
        return [type(t).__name__ for t in compose.transforms]
    assert names(got.train_transform) == names(want.train_transform) == [
        "RandomHorizontalFlip", "RandomSelect"]
    assert type(got.val_transform).__name__ == \
        type(want.val_transform).__name__ == "RandomResizeWithAspectRatio"


def test_loader_raises_a_sample_error_in_order(coco_dir, tmp_path):
    """A worker's exception reaches the consumer at its sample's turn."""
    root = str(tmp_path / "coco")
    shutil.copytree(coco_dir, root)
    for name in os.listdir(os.path.join(root, "val2017")):
        shutil.copy(FIXTURES / "corrupt.jpg", os.path.join(root, "val2017",
                                                           name))
    ds = tds.CocoDetectionDataset(split=tds.Split.VAL, dataset_dir=root)
    with pytest.raises(tds.base_dataset.InvalidSampleError):
        next(iter(ds.stream_loader(num_workers=2)))


def test_abandoned_loader_stops_its_workers(coco_dir):
    ds = tds.CocoDetectionDataset(dataset_dir=coco_dir)
    before = threading.active_count()
    it = iter(ds.train_loader(batch_size=1, num_workers=4, shuffle=False))
    next(it)
    it.close()
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=10)
    assert threading.active_count() <= before


def test_sample_loader_yields_torch_frames():
    ds = tds.CocoBaseDataset(sample=True, return_masks=True)
    batch = next(iter(ds.train_loader(batch_size=3, seed=0)))
    assert len(batch) == 3
    assert all(isinstance(f.array, torch.Tensor) for f in batch)
