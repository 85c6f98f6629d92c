"""The port's tracking and crowd datasets on disk against the JAX package's,
on seeded directories in the published layouts written in ``tmp_path`` by
the port's ``utils/tracking_fixture.py`` at small sizes: MOT17 (every knob:
``detections_set``, ``visibility_threshold``, the sequence filters,
``sequence_size``/``sequence_skip``, ``random_step``), CrowdHuman
(``bbox_types``, ``boxes_limit``, the test split, ``prepare()``) and
WoodScape (``cameras``, ``fragment`` as an int, a float and negative,
``seg_classes``, ``merge_classes``, the split dataset); their samples. Also
``prepare()``'s uint8 resize against ``cv2.resize`` on 200 random sizes,
its JPEG writer against ``cv2.imwrite`` and the fixture writers against
``cv2.imread``.

Tolerances: frames, boxes, labels and track ids, masks equal (every read is
bit-equal; boxes are computed in the same float32 / float64 arithmetic);
item lists equal; the prepared images decode equal (0 measured) and their
files are byte-equal to cv2's.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import aloception_tpu.alodataset as jds
import aloception_tpu.alodataset.base_dataset as jbase
import aloception_tpu_torch.alodataset as tds
import aloception_tpu_torch.alodataset.base_dataset as tbase
from aloception_tpu_torch.runtime import decode, resize_linear_u8
from aloception_tpu_torch.utils import tracking_fixture as tf

from test_torch_aloscene import same

HW = (24, 32)


@pytest.fixture(autouse=True)
def private_config(tmp_path, monkeypatch):
    """Both packages' dataset config under the test's own directory."""
    path = str(tmp_path / "alodataset_config.json")
    monkeypatch.setattr(jbase, "CONFIG_PATH", path)
    monkeypatch.setattr(tbase, "CONFIG_PATH", path)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracking")
    return dict(
        mot=tf.build_mot17_dir(
            str(root / "mot"), seed=1, frames=6, hw=HW, tracks=5,
            sequences=("MOT17-02-FRCNN", "MOT17-02-DPM", "MOT17-04-FRCNN",
                       "MOT17-05-SDP")),
        woodscape=tf.build_woodscape_dir(str(root / "ws"), seed=3, n=3,
                                         hw=HW))


def both(name, split=None, **kw):
    if split is not None:
        kw["split"] = getattr(tds.Split, split)
        jkw = dict(kw, split=getattr(jds.Split, split))
    else:
        jkw = kw
    return getattr(tds, name)(**kw), getattr(jds, name)(**jkw)


def same_items(got, want):
    assert len(got) == len(want) > 0
    assert got.items == want.items


def same_all(got, want, **getkw):
    same_items(got, want)
    for i in range(len(got)):
        same(got.getitem(i, **getkw), want.getitem(i), rtol=0, atol=0)


# ----------------------------------------------------------------------
# MOT17
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(detections_set="DPM"),
    dict(detections_set=["FRCNN", "SDP"]),
    dict(visibility_threshold=0.5), dict(sequence_size=3, sequence_skip=1),
    dict(sequence_size=1),
    dict(split="VAL", validation_sequences=["MOT17-04"]),
    dict(split="TRAIN", validation_sequences=["MOT17-04"]),
    dict(training_sequences=["MOT17-02"])],
    ids=["default", "dpm", "frcnn_sdp", "visibility", "size3_skip1",
         "size1", "val_split", "train_without_val", "training_sequences"])
def test_mot17_equals_jax(dirs, kw):
    kw = dict(kw)
    split = kw.pop("split", "TRAIN")
    got, want = both("Mot17", split=split, dataset_dir=dirs["mot"], **kw)
    same_all(got, want)
    item = got.getitem(0)
    assert item.names[0] == "T"
    assert item.boxes2d[0].labels.labels_names is None   # track ids


def test_mot17_random_step_windows_follow_the_jax_clamp(dirs, monkeypatch):
    """The port draws the step from (transform_seed, epoch, index); its
    windows obey JAX's clamp; with the step forced, the frames are equal."""
    got, want = both("Mot17", split="TRAIN", dataset_dir=dirs["mot"],
                     sequence_size=3, random_step=4, transform_seed=5)
    steps = set()
    for idx in range(len(got)):
        seq, ids = got.items[idx]
        last = got.seq_len[seq]
        for epoch in range(3):
            item = got.get(idx, epoch)
            assert same_draw(got, idx, epoch, item)
        for step in range(1, 5):
            w = got.window(idx, step)
            if ids[0] + 2 * step <= last:
                assert w == [ids[0], ids[0] + step, ids[0] + 2 * step]
            else:
                s = max(1, (last - ids[0]) // 2)
                assert w == [ids[0] + k * s for k in range(3)]
            steps.add(w[1] - w[0])
    assert len(steps) > 1
    # the step forced on both sides: equal frames
    for step in (1, 2, 4):
        monkeypatch.setattr(np.random, "randint", lambda lo, hi: step)
        monkeypatch.setattr(torch, "randint",
                            lambda lo, hi, size, generator: torch.tensor(step))
        for idx in (0, len(got) - 1):
            same(got.getitem(idx), want.getitem(idx), rtol=0, atol=0)


def same_draw(ds, idx, epoch, item):
    """The item of (idx, epoch) is the one of its drawn window, every time."""
    again = ds.get(idx, epoch)
    same(item, again, rtol=0, atol=0)
    return True


def test_mot17_sample():
    got, want = tds.Mot17(sample=True), jds.Mot17(sample=True)
    for i in range(4):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=0)


# ----------------------------------------------------------------------
# CrowdHuman
# ----------------------------------------------------------------------
@pytest.fixture
def crowd_dir(tmp_path):
    return tf.build_crowd_human_dir(
        str(tmp_path / "crowd"), seed=2,
        sizes=((40, 60), (30, 20), (24, 32), (20, 28)), test_images=3)


@pytest.mark.parametrize("kw", [
    dict(), dict(box_key="vbox"), dict(bbox_types=["fbox", "vbox", "hbox"]),
    dict(boxes_limit=2), dict(split="VAL"), dict(split="TEST")],
    ids=["fbox", "vbox_primary", "bbox_types", "boxes_limit", "val",
         "test_split"])
def test_crowd_human_equals_jax(crowd_dir, kw):
    kw = dict(kw)
    split = kw.pop("split", "TRAIN")
    got, want = both("CrowdHumanDataset", split=split, dataset_dir=crowd_dir,
                     **kw)
    same_all(got, want)
    if split == "TRAIN" and "bbox_types" in kw:
        assert set(got.getitem(0).boxes2d) == {"fbox", "vbox", "hbox"}


def test_crowd_human_sample():
    got, want = (tds.CrowdHumanDataset(sample=True),
                 jds.CrowdHumanDataset(sample=True))
    for i in range(6):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=0)


def test_crowd_human_prepare_writes_the_jax_files(tmp_path, private_config):
    """Both packages prepare a copy of one directory (two of its images are
    larger than the 1333 limit): the same file names, annotation files
    equal, images whose decoded pixels are equal (measured: 0 differing;
    the bytes are equal too), the config repointed, the prepared datasets'
    items equal."""
    sizes = ((40, 1400), (1500, 30), (24, 32), (20, 28))
    src = tf.build_crowd_human_dir(str(tmp_path / "t" / "crowd"), seed=4,
                                   sizes=sizes)
    shutil.copytree(src, str(tmp_path / "j" / "crowd"))
    got = tds.CrowdHumanDataset(dataset_dir=src)
    want = jds.CrowdHumanDataset(dataset_dir=str(tmp_path / "j" / "crowd"))
    out_t, out_j = got.prepare(), want.prepare()
    assert out_t.endswith("crowd_prepared") and out_j.endswith(
        "crowd_prepared")
    assert not os.path.exists(str(tmp_path / "t" / ".wip_crowd_prepared"))
    files_t = sorted(os.path.relpath(os.path.join(r, f), out_t)
                     for r, _, fs in os.walk(out_t) for f in fs)
    files_j = sorted(os.path.relpath(os.path.join(r, f), out_j)
                     for r, _, fs in os.walk(out_j) for f in fs)
    assert files_t == files_j and len(files_t) == 5
    shapes = set()
    for rel in files_t:
        a, b = os.path.join(out_t, rel), os.path.join(out_j, rel)
        if rel.endswith(".odgt"):
            assert open(a).read() == open(b).read()
            continue
        pa, pb = decode(a).numpy(), cv2.imread(b)[..., ::-1]
        assert pa.shape == pb.shape and (pa == pb).all()
        assert open(a, "rb").read() == open(b, "rb").read()
        shapes.add(pa.shape[:2])
    assert {(38, 1333), (1333, 27)} <= shapes      # the two large ones
    with open(private_config) as f:
        assert json.load(f)["CrowdHuman"] == out_j
    same_all(got, want)
    # idempotent: a prepared dataset prepares to itself
    assert got.prepare() == out_t


def test_uint8_resize_equals_cv2_on_200_sizes():
    rng = np.random.RandomState(0)
    for k in range(200):
        h, w = rng.randint(1, 160, 2)
        oh, ow = rng.randint(1, 160, 2)
        c = (1, 3)[k % 2]
        src = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        want = cv2.resize(src, (int(ow), int(oh)),
                          interpolation=cv2.INTER_LINEAR).reshape(oh, ow, c)
        assert (resize_linear_u8(src, (oh, ow)) == want).all(), (h, w, oh, ow)
    src = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)  # exact 2x
    assert (resize_linear_u8(src, (100, 150))
            == cv2.resize(src, (150, 100), interpolation=cv2.INTER_LINEAR)
            ).all()


def test_prepare_jpeg_writer_is_cv2_imwrite(tmp_path):
    from aloception_tpu_torch.alodataset.crowd_human import write_jpeg
    rng = np.random.RandomState(3)
    for k in range(6):
        img = tf.scene_image(rng, (int(rng.randint(8, 90)),
                                   int(rng.randint(8, 90))))
        a, b = str(tmp_path / f"p{k}.jpg"), str(tmp_path / f"c{k}.jpg")
        write_jpeg(a, img)
        cv2.imwrite(b, img[..., ::-1])
        assert open(a, "rb").read() == open(b, "rb").read()


# ----------------------------------------------------------------------
# WoodScape
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(cameras=["FV", "MVL"]), dict(fragment=5),
    dict(fragment=0.5), dict(fragment=-0.25), dict(fragment=-3),
    dict(labels=["seg"]), dict(labels=["boxes_2d", "seg"],
                               seg_classes=["road", "person", "curb"]),
    dict(labels=["seg"], seg_classes=["road", "curb"], merge_classes=True,
         rename_merged="ground")],
    ids=["default", "cameras", "fragment_int", "fragment_float",
         "fragment_negative", "fragment_negative_int", "seg",
         "seg_classes", "merge_classes"])
def test_woodscape_equals_jax(dirs, kw):
    got, want = both("WooDScapeDataset", dataset_dir=dirs["woodscape"], **kw)
    same_all(got, want)


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_woodscape_split_equals_jax(dirs, split):
    got, want = both("WooDScapeSplitDataset", split=split,
                     dataset_dir=dirs["woodscape"], labels=["boxes_2d", "seg"])
    same_all(got, want)


def test_woodscape_sample():
    got, want = (tds.WooDScapeDataset(sample=True),
                 jds.WooDScapeDataset(sample=True))
    for i in range(4):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=0)


# ----------------------------------------------------------------------
# the fixture writers against cv2
# ----------------------------------------------------------------------
def test_fixture_files_read_back_through_cv2(dirs, tmp_path):
    """The images read by cv2 equal the port's reads; the gtLabels PNG is
    the class-index plane; the MOT17 ini and the WoodScape boxes parse."""
    mot = os.path.join(dirs["mot"], "train", "MOT17-02-FRCNN")
    jpg = os.path.join(mot, "img1", "000001.jpg")
    assert (cv2.imread(jpg)[..., ::-1] == decode(jpg).numpy()).all()
    assert cv2.imread(jpg).shape == HW + (3,)
    for name in os.listdir(os.path.join(dirs["woodscape"], "rgb_images")):
        p = os.path.join(dirs["woodscape"], "rgb_images", name)
        assert (cv2.imread(p)[..., ::-1] == decode(p).numpy()).all()
        g = os.path.join(dirs["woodscape"], "semantic_annotations",
                         "gtLabels", name)
        sem = cv2.imread(g, cv2.IMREAD_GRAYSCALE)
        assert sem.shape == HW and sem.max() <= 9
        assert (sem == decode(g, "gray")[..., 0].numpy()).all()
    crowd = tf.build_crowd_human_dir(str(tmp_path / "c"), seed=0,
                                     sizes=((30, 40), (20, 10)))
    recs = [json.loads(x) for x in open(os.path.join(
        crowd, "annotation_train.odgt"))]
    for rec in recs:
        img = cv2.imread(os.path.join(crowd, "CrowdHuman_train", "Images",
                                      rec["ID"] + ".jpg"))
        assert img is not None and img.shape[2] == 3
    assert [len(r["gtboxes"]) for r in recs][-1] == 1
