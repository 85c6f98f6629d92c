"""The port's KITTI and Waymo datasets against the JAX package's, on seeded
directories in the published layouts written in ``tmp_path`` by the port's
``utils/flow_fixture.py`` at 24x32 (Waymo 32x48): the calibration parsers;
scene flow 2015 and the 2012 reader; depth, object, tracking, odometry,
road, semantic and the depth split; each with its sample; the Waymo
converter, byte for byte, on the TFRecord of ``test_waymo_prepare.py``'s
encoder and on the writer's; ``WaymoDataset`` on the prepared layout.

Tolerances: images, flows, disparities, depths, masks and poses equal;
boxes and intrinsics 1e-6 (in practice equal: both packages compute them in
the same float64 then float32 steps)."""

import filecmp
import os

import numpy as np
import pytest

import aloception_tpu.alodataset as jds
import aloception_tpu.alodataset.base_dataset as jbase
import aloception_tpu_torch.alodataset as tds
import aloception_tpu_torch.alodataset.base_dataset as tbase
from aloception_tpu.alodataset.prepare import waymo_converter as jwc
from aloception_tpu.alodataset.waymo import WaymoDataset as JWaymo
from aloception_tpu_torch.alodataset.prepare import waymo_converter as twc
from aloception_tpu_torch.alodataset.waymo import WaymoDataset
from aloception_tpu_torch.utils import flow_fixture as ff

from test_torch_aloscene import same

HW = (24, 32)


@pytest.fixture(autouse=True)
def private_config(tmp_path, monkeypatch):
    """Both packages' dataset config under the test's own directory."""
    path = str(tmp_path / "alodataset_config.json")
    monkeypatch.setattr(jbase, "CONFIG_PATH", path)
    monkeypatch.setattr(tbase, "CONFIG_PATH", path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return dict(
        sflow=ff.build_kitti_sflow_dir(str(root / "sflow"), 1, hw=HW),
        obj=ff.build_kitti_object_dir(str(root / "obj"), 2, hw=HW, boxes=6),
        depth=ff.build_kitti_depth_dir(str(root / "depth"), 3,
                                       subsets=("val", "train"), hw=HW),
        track=ff.build_kitti_tracking_dir(str(root / "track"), 4, hw=HW),
        odo=ff.build_kitti_odometry_dir(str(root / "odo"), 5, hw=HW),
        road=ff.build_kitti_road_dir(str(root / "road"), 6, hw=HW),
        sem=ff.build_kitti_semantic_dir(str(root / "sem"), 7, hw=HW))


def same_dataset(name, atol=0.0, split=None, **kw):
    """Both packages' ``name``: equal items, every getitem within ``atol``
    (and the samples equal)."""
    tkw, jkw = dict(kw), dict(kw)
    if split:
        tkw["split"], jkw["split"] = (getattr(tds.Split, split),
                                      getattr(jds.Split, split))
    got, want = getattr(tds, name)(**tkw), getattr(jds, name)(**jkw)
    assert got.items == want.items and len(got) > 0
    for i in range(len(got)):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=atol)
    tkw.pop("dataset_dir"), jkw.pop("dataset_dir")
    got, want = (getattr(tds, name)(sample=True, **tkw),
                 getattr(jds, name)(sample=True, **jkw))
    for i in range(len(got)):
        same(got[i], want.getitem(i), rtol=0, atol=atol)
    return getattr(tds, name)(**dict(tkw, dataset_dir=kw["dataset_dir"]))


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cams", [(0, 1, 2, 3), (0, 1, 2)])
def test_calibration_parsers_match_jax(cams, tmp_path):
    """The time stamp line parses to nothing; P_rect_0X as 3x4 float32; the
    baseline from P2/P3 (None without P_rect_03); KeyError without a
    projection matrix."""
    from aloception_tpu.alodataset.utils import kitti as jk
    from aloception_tpu_torch.alodataset.utils import kitti as tk
    path = str(tmp_path / "calib.txt")
    with open(path, "w") as f:
        f.write(ff.calib_cam_to_cam_text(cams))
    got, want = tk.load_calib_cam_to_cam(path), jk.load_calib_cam_to_cam(path)
    assert got.keys() == want.keys() and "calib_time" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tk.baseline_from_calib(got) == jk.baseline_from_calib(want)
    assert (tk.baseline_from_calib(got) is None) == (3 not in cams)
    for cam in (2, 3):
        if cam in cams:
            np.testing.assert_array_equal(tk.intrinsic_from_calib(got, cam),
                                          jk.intrinsic_from_calib(want, cam))
        else:
            with pytest.raises(KeyError):
                tk.intrinsic_from_calib(got, cam)


# ----------------------------------------------------------------------
# the KITTI datasets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["KittiStereoFlowSFlow2015",
                                  "KittiStereoFlow2012"])
def test_scene_flow_matches_jax(dirs, name):
    """Without disparities (where the JAX dataset runs): both cameras, the
    flows with their occlusions, the intrinsics; the last id has no right
    camera."""
    ds = same_dataset(name, dataset_dir=dirs["sflow"],
                      load=["right", "flow_occ", "flow_noc"])
    assert set(ds.getitem(0)) == {"left", "right"}
    assert set(ds.getitem(len(ds) - 1)) == {"left"}


def test_scene_flow_disparities_at_both_times(dirs):
    """With the default ``load``, the left frames carry ``disp_*_0`` at t
    and ``disp_*_1`` at t+1, each equal to the JAX reader's array, with
    the baseline of the calibration (None without P_rect_03); the JAX
    dataset attaches the disparity at t only and fails to concatenate
    (ROADMAP §C). The flows equal the JAX dataset's."""
    from aloception_tpu.alodataset.kitti import (_load_kitti_disp_png,
                                                 _load_kitti_flow_png)
    with pytest.raises(ValueError, match="disparity"):
        jds.KittiStereoFlowSFlow2015(dataset_dir=dirs["sflow"]).getitem(0)
    ds = tds.KittiStereoFlowSFlow2015(dataset_dir=dirs["sflow"])
    base = os.path.join(dirs["sflow"], "training")
    for i, fid in enumerate(ds.items):
        left = ds.getitem(i)["left"]
        disp = left.get_child("disparity")
        for key in ("disp_noc", "disp_occ"):
            assert disp[key].baseline == (None if i == len(ds) - 1
                                          else pytest.approx(0.5327254))
            for t in (0, 1):
                np.testing.assert_array_equal(
                    disp[key].array[t].numpy(), _load_kitti_disp_png(
                        os.path.join(base, f"{key}_{t}", f"{fid:06d}_10.png")))
        flows = left.get_child("flow")
        assert flows[1] is None
        for key in ("flow_occ", "flow_noc"):
            flow, valid = _load_kitti_flow_png(
                os.path.join(base, key, f"{fid:06d}_10.png"))
            np.testing.assert_array_equal(flows[0][key].array.numpy(), flow)
            np.testing.assert_array_equal(
                flows[0][key].occlusion.array.numpy()[0], ~valid)


def test_object_matches_jax(dirs):
    """Boxes of the 8 classes (the DontCare lines dropped), 2-D relative
    xcyc and 3-D centres; P2 as the intrinsic, none where the calibration
    file is missing."""
    ds = same_dataset("KittiObject", atol=1e-6, dataset_dir=dirs["obj"])
    frame = ds.getitem(0)
    assert frame.boxes2d.shape == (6, 4) and frame.boxes3d.shape == (6, 7)
    assert frame.get_child("cam_intrinsic") is not None
    assert ds.getitem(1).get_child("cam_intrinsic") is None


@pytest.mark.parametrize("name,split", [("KittiDepth", None),
                                        ("KittiSplit", "TRAIN"),
                                        ("KittiSplit", "VAL")])
def test_depth_matches_jax(dirs, name, split):
    """The sparse 16-bit depth / 256 (a sample frame where the RGB file is
    missing); the split's ``valid_mask`` on the depth."""
    ds = same_dataset(name, split=split, dataset_dir=dirs["depth"])
    last = ds.getitem(len(ds) - 1)
    if name == "KittiDepth" or split == "VAL":
        assert last.HW == (96, 128)             # the RGB file is missing
    depth = ds.getitem(0).depth
    if name == "KittiSplit":
        np.testing.assert_array_equal(depth.valid_mask.array.numpy(),
                                      (depth.array.numpy() != 0))


@pytest.mark.parametrize("name,key", [("KittiTracking", "track"),
                                      ("KittiOdometry", "odo"),
                                      ("KittiRoad", "road"),
                                      ("KittiSemantic", "sem")])
def test_sequences_and_segmentation_match_jax(dirs, name, key):
    """Tracking and odometry sequences (poses where the file exists), the
    road mask (the ground truth's red channel), the semantic masks in
    ``np.unique`` order of the grey read (a colour PNG through the PNG grey
    conversion)."""
    ds = same_dataset(name, dataset_dir=dirs[key])
    if name == "KittiOdometry":
        assert ds.getitem(0).get_child("pose") is not None
        assert ds.getitem(len(ds) - 1).get_child("pose") is None
    if name == "KittiSemantic":
        assert ds.getitem(1).segmentation.shape[0] > 6   # the noisy channel


def test_lazy_names_match_jax():
    for name in ("KittiStereoFlowSFlow2015Dataset", "KittiSplitDataset",
                 "KittiDepthDataset", "KittiObjectDataset", "WaymoDataset",
                 "FlyingThings3DSubsetDataset", "ChairsSDHomDataset",
                 "Mot17", "CrowdHumanDataset", "WooDScapeDataset",
                 "WooDScapeSplitDataset"):
        assert getattr(tds, name).__name__ == getattr(jds, name).__name__
    with pytest.raises(AttributeError):
        tds.NotADataset


# ----------------------------------------------------------------------
# Waymo
# ----------------------------------------------------------------------
def test_waymo_converter_writes_the_jax_files(tmp_path):
    """Both converters on the TFRecord of ``test_waymo_prepare.py``'s
    encoder (cv2 JPEGs) and on the writer's (Pillow JPEGs, 2 segments):
    the same file names and the same bytes; ``parse_frame`` equal."""
    from test_waymo_prepare import _encode_frame
    rec = tmp_path / "records"
    rec.mkdir()
    records = [_encode_frame(i) for i in range(3)]
    twc.write_tfrecord(str(rec / "segment-test_with_camera_labels.tfrecord"),
                       records)
    ff.build_waymo_tfrecord_dir(str(rec), 9, frames=2, hw=(32, 48), boxes=5,
                                cameras=(1, 2), segments=2)
    for r in records:
        assert twc.parse_frame(r) == jwc.parse_frame(r)
    got = twc.prepare(str(rec), str(tmp_path / "port"))
    want = jwc.prepare(str(rec), str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    n = 0
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(dirpath, tmp_path / "jax")
        assert sorted(os.listdir(tmp_path / "port" / rel)) == sorted(
            os.listdir(dirpath))
        for f in files:
            assert filecmp.cmp(os.path.join(dirpath, f),
                               tmp_path / "port" / rel / f, shallow=False)
            n += 1
    assert n == 2 * 3 + 2 * 2 * 2 * 2


@pytest.mark.parametrize("labels,T", [(("gt_boxes_2d",), 2),
                                      (("gt_boxes_2d", "gt_boxes_3d"), 3)])
def test_waymo_dataset_matches_jax(tmp_path, labels, T):
    """The prepared layout: JPEG frames (Pillow against cv2), absolute xcyc
    2-D boxes, the 3-D boxes and extrinsic in aloception's axes, the
    intrinsic; the sample."""
    ff.build_waymo_tfrecord_dir(str(tmp_path / "rec"), 8, frames=4,
                                hw=(32, 48), boxes=6, cameras=(1, 2))
    WaymoDataset.prepare(str(tmp_path / "rec"), str(tmp_path / "w" / "train"))
    kw = dict(dataset_dir=str(tmp_path / "w"), labels=labels,
              sequence_size=T, cameras=("front", "front_left"))
    got, want = WaymoDataset(**kw), JWaymo(**kw)
    assert got.items == want.items and len(got) == 4 - T + 1
    for i in range(len(got)):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=1e-6)
    item = got.getitem(0)["front"]
    assert item.get_child("cam_extrinsic").shape == (T, 4, 4)
    if "gt_boxes_3d" in labels:
        assert item.boxes3d[0].shape[1] == 7
    for i in range(4):
        same(WaymoDataset(sample=True)[i], JWaymo(sample=True).getitem(i),
             rtol=0, atol=0)
