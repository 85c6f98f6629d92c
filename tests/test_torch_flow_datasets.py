"""The port's flow datasets on disk against the JAX package's, on seeded
directories in the published layouts, written in ``tmp_path`` by the port's
``utils/flow_fixture.py`` at 24x32: Sintel (the four classes, sequences of
2 and 3 with a skip), FlyingChairs2, the FlyingThings3D subset and
ChairsSDHom, each split; their samples; ``Data2RAFT.prepare_batch`` from
each directory; ``train_on_chairs`` and ``eval_on_sintel`` from files, and
both packages' ``eval_on_sintel`` on one directory and the same weights.
Also the fixture writer against ``cv2.imread`` and the JAX readers: 16-bit
grey and RGB PNG, ``.flo``, ``.pfm`` and Sintel's disparity encoding.

Tolerances: images, flows, occlusions, disparities equal (every read is
bit-equal); the EPE of the two packages' ``eval_on_sintel`` 1e-4 relative
(float32 convolutions summed in another order through 2 recurrent steps).
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
from aloception_tpu_torch.aloscene import InvalidSampleError
from aloception_tpu_torch.utils import flow_fixture as ff
from aloception_tpu_torch.utils.coco_fixture import write_png

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
    root = tmp_path_factory.mktemp("flow")
    return dict(
        sintel=ff.build_sintel_dir(str(root / "sintel"), seed=1, scenes=2,
                                   frames=4, hw=HW),
        chairs=ff.build_chairs2_dir(str(root / "chairs"), seed=2, hw=HW),
        things=ff.build_things_dir(str(root / "things"), seed=3, hw=HW),
        sdhom=ff.build_sdhom_dir(str(root / "sdhom"), seed=4, hw=HW))


def configure(path, **entries):
    with open(path, "w") as f:
        json.dump(entries, f)


def same_dataset(name, split="TRAIN", **kw):
    """Both packages' ``name`` dataset: equal items, every getitem equal."""
    got = getattr(tds, name)(split=getattr(tds.Split, split), **kw)
    want = getattr(jds, name)(split=getattr(jds.Split, split), **kw)
    assert got.items == want.items and len(got) > 0
    for i in range(len(got)):
        same(got.getitem(i), want.getitem(i), rtol=0, atol=0)
    return got


# ----------------------------------------------------------------------
# the fixture writer against cv2 and the JAX readers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["grey16", "rgb16", "grey8", "rgb8"])
def test_png_writer_reads_back_through_cv2(kind, tmp_path):
    rng = np.random.RandomState(5)
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    shape = HW + ((3,) if kind.startswith("rgb") else ())
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got[..., ::-1] if img.ndim == 3 else got,
                                  img)


def test_flo_and_pfm_writers_read_back_through_cv2_and_jax(tmp_path):
    from aloception_tpu.aloscene.io.disparity import load_pfm
    from aloception_tpu.aloscene.io.flow import load_flow_flo
    from aloception_tpu_torch.aloscene.io.flow import save_flow_flo
    rng = np.random.RandomState(6)
    flow = ff.smooth_flow(rng, HW)
    save_flow_flo(str(tmp_path / "f.flo"), flow)
    np.testing.assert_array_equal(
        cv2.readOpticalFlow(str(tmp_path / "f.flo")), np.moveaxis(flow, 0, -1))
    np.testing.assert_array_equal(load_flow_flo(str(tmp_path / "f.flo")),
                                  flow)
    for c in (1, 3):
        arr = rng.randn(c, *HW).astype(np.float32)
        path = str(tmp_path / f"d{c}.pfm")
        ff.write_pfm(path, arr)
        np.testing.assert_array_equal(load_pfm(path), arr)
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = arr[0] if c == 1 else np.moveaxis(arr, 0, -1)[..., ::-1]
        np.testing.assert_array_equal(got, want)


def test_sintel_disparity_encoding_reads_back_through_cv2(tmp_path):
    """The encoding read by cv2 and decoded as the JAX dataset decodes it
    (R * 4 + G / 64 + B / 16384 of a BGR read) gives the disparity back to
    1/16384, and the port's decoder gives the same float32 values."""
    from aloception_tpu_torch.alodataset.sintel import decode_sintel_disparity
    disp = np.abs(ff.smooth_flow(np.random.RandomState(7), HW, 60.0)[0]) + 1
    path = str(tmp_path / "d.png")
    write_png(path, ff.sintel_disparity_rgb(disp))
    b, g, r = np.moveaxis(cv2.imread(path).astype(np.float32), -1, 0)
    want = r * 4 + g / 64 + b / 16384
    assert np.abs(want - disp).max() < 1 / 16384 + 1e-4
    np.testing.assert_array_equal(decode_sintel_disparity(path).numpy(), want)


# ----------------------------------------------------------------------
# the datasets on disk and their samples
# ----------------------------------------------------------------------
SINTEL_CASES = [("SintelFlowDataset", {}), ("SintelDisparityDataset", {}),
                ("SintelMultiDataset", {}), ("SintelBaseDataset", {}),
                ("SintelFlowDataset", dict(sequence_size=3)),
                ("SintelMultiDataset", dict(sequence_size=2,
                                            sequence_skip=1))]


@pytest.mark.parametrize("name,kw", SINTEL_CASES,
                         ids=[f"{n}-{kw}" for n, kw in SINTEL_CASES])
def test_sintel_matches_jax(dirs, name, kw):
    ds = same_dataset(name, "VAL", dataset_dir=dirs["sintel"], **kw)
    T = kw.get("sequence_size", 2)
    assert len(ds) == 2 * (4 - (T - 1) * (kw.get("sequence_skip", 0) + 1))
    item = ds.getitem(0)
    assert item.names == ("T", "C", "H", "W") and item.shape[:2] == (T, 3)
    if name in ("SintelFlowDataset", "SintelMultiDataset"):
        flows = item.get_child("flow")
        assert len(flows) == T and flows[-1] is None
        assert flows[0]["flow_forward"].get_child("occlusion") is not None


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_chairs2_matches_jax(dirs, split):
    ds = same_dataset("FlyingChairs2Dataset", split,
                      dataset_dir=dirs["chairs"])
    # the backward flow beside the first pair is not indexed
    assert len(ds) == (4 if split == "TRAIN" else 2)


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_flying_things_matches_jax(dirs, split):
    """Pairs of consecutive ids only (ids 0, 1, 2, 4, 5: three pairs)."""
    ds = same_dataset("FlyingThings3DSubsetDataset", split,
                      dataset_dir=dirs["things"])
    assert [i0 for _, _, i0 in ds.items] == [0, 1, 4]


def test_flying_things_disparity_on_both_frames(dirs):
    """With ``labels`` holding "disparity", each frame carries its own
    ``.pfm`` disparity, read as the JAX reader reads it; the JAX dataset
    attaches the first frame's only and its pair fails to concatenate
    (ROADMAP §C)."""
    import aloception_tpu.aloscene as jsc
    kw = dict(dataset_dir=dirs["things"], labels=("flow", "disparity"))
    with pytest.raises(ValueError, match="disparity"):
        jds.FlyingThings3DSubsetDataset(**kw).getitem(0)
    ds = tds.FlyingThings3DSubsetDataset(**kw)
    flow_only = tds.FlyingThings3DSubsetDataset(dataset_dir=dirs["things"])
    for i, (_, _, i0) in enumerate(ds.items):
        item = ds.getitem(i)
        disp = item.get_child("disparity")
        assert disp.names == ("T", "C", "H", "W")
        for t in (0, 1):
            want = jsc.Disparity(os.path.join(
                dirs["things"], "train", "disparity", "left",
                f"{i0 + t:07d}.pfm"), png_negate=False, camera_side="left")
            same(disp[t], want, rtol=0, atol=0)
        same(item.get_child("flow"), flow_only.getitem(i).get_child("flow"))


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_chairs_sdhom_matches_jax(dirs, split):
    """The first stem's flow is a .flo, the others the first two channels
    of a 3-channel .pfm."""
    same_dataset("ChairsSDHomDataset", split, dataset_dir=dirs["sdhom"])


@pytest.mark.parametrize("name", ["SintelFlowDataset", "SintelMultiDataset",
                                  "FlyingChairs2Dataset",
                                  "FlyingThings3DSubsetDataset",
                                  "ChairsSDHomDataset"])
def test_flow_samples_match_jax(name):
    got, want = getattr(tds, name)(sample=True), getattr(jds, name)(
        sample=True)
    assert len(got) == len(want)
    for i in range(len(got)):
        same(got[i], want.getitem(i), rtol=0, atol=0)


def test_missing_directory_and_unreadable_file_raise(dirs, tmp_path):
    """No configured directory: FileNotFoundError in both packages. An
    unreadable frame: ``InvalidSampleError`` in both (the port's ``get``
    retries it at idx + 17, as the JAX package does)."""
    for pkg in (tds, jds):
        with pytest.raises(FileNotFoundError, match="FlyingChairs2"):
            pkg.FlyingChairs2Dataset()
    broken = str(tmp_path / "chairs")
    shutil.copytree(dirs["chairs"], broken)
    with open(os.path.join(broken, "train", "0000001-img_0.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n broken")
    from aloception_tpu.aloscene import InvalidSampleError as JInvalid
    with pytest.raises(JInvalid):
        jds.FlyingChairs2Dataset(dataset_dir=broken).getitem(1)
    ds = tds.FlyingChairs2Dataset(dataset_dir=broken, max_retry_on_error=0)
    with pytest.raises(InvalidSampleError):
        ds.getitem(1)
    same(tds.FlyingChairs2Dataset(dataset_dir=broken, retry_offset=1)[1],
         jds.FlyingChairs2Dataset(dataset_dir=broken).getitem(2), atol=0)


# ----------------------------------------------------------------------
# Data2RAFT and the commands on disk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dataset", ["chairs", "things", "sdhom", "sintel"])
def test_data2raft_from_disk_matches_jax(dirs, dataset):
    """``prepare_batch`` of the same pairs from disk: the JAX NHWC batch
    transposed to NCHW, at the frames' own size (``size`` is not used)."""
    from aloception_tpu.train import Data2RAFT as JaxDM
    from aloception_tpu_torch.train import Data2RAFT
    kw = dict(dataset=dataset, dataset_dir=dirs[dataset], num_workers=0)
    jdm, tdm = JaxDM(**kw), Data2RAFT(**kw)
    assert len(tdm.val_dataset) == len(jdm.val_dataset)
    jb = jdm.prepare_batch([jdm.train_dataset.getitem(i) for i in (0, 1)])
    tb = tdm.prepare_batch([tdm.train_dataset[i] for i in (0, 1)])
    for g, w in zip(tb["inputs"], jb["inputs"]):
        assert g.shape == (2, 3) + HW
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(), w)
    np.testing.assert_array_equal(
        tb["targets"]["flow"].permute(0, 2, 3, 1).numpy(),
        jb["targets"]["flow"])
    np.testing.assert_array_equal(tb["targets"]["valid"].numpy(),
                                  jb["targets"]["valid"])


def test_train_on_chairs_then_eval_on_sintel_from_files(
        dirs, private_config, tmp_path, capsys, monkeypatch):
    """``train_on_chairs --cpu --tiny --max_steps 2`` on the directory the
    config names (its train pairs, validation on val), then
    ``eval_on_sintel --cpu --tiny`` from its checkpoint on the Sintel
    directory (Padder to 24x32, 6 pairs of 2 scenes)."""
    from aloception_tpu_torch.commands import eval_on_sintel, train_on_chairs
    from aloception_tpu_torch.train import experiment
    monkeypatch.setattr(experiment, "CONFIG_PATH",
                        str(tmp_path / "alonet_config.json"))
    configure(private_config, FlyingChairs2=dirs["chairs"],
              Sintel=dirs["sintel"])
    trainer = train_on_chairs.main(
        ["--cpu", "--tiny", "--max_steps", "2", "--batch_size", "2",
         "--iters", "2", "--num_workers", "2", "--log_dir", str(tmp_path)])
    assert "[train_on_chairs] done: step=2" in capsys.readouterr().out
    assert trainer.data_module.train_dataset.dir_path == os.path.join(
        dirs["chairs"], "train")
    assert np.isfinite(trainer.last_val_metrics["val_loss_total"])
    epe = eval_on_sintel.main(["--cpu", "--tiny", "--iters", "2",
                               "--ckpt_dir", trainer.ckpt_dir])
    out = capsys.readouterr().out
    assert "[eval] restored step 2" in out and "over 6 pairs" in out
    assert np.isfinite(epe) and epe > 0


def test_eval_on_sintel_from_files_matches_jax(dirs, private_config,
                                               tmp_path):
    """Both packages' ``eval_on_sintel --cpu --tiny --weights`` on the same
    directory and the same reference state_dict (a seeded port model's,
    which the JAX command converts with ``convert_raft_checkpoint``): the
    EPE within 1e-4 relative."""
    from aloception_tpu.commands import eval_on_sintel as jeval
    from aloception_tpu_torch.commands import eval_on_sintel
    from aloception_tpu_torch.models import raft as traft
    configure(private_config, Sintel=dirs["sintel"])
    model = traft.built(traft.RAFTBase(
        hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=2,
        device="cpu", generator=torch.Generator().manual_seed(3)),
        torch.float32)
    path = str(tmp_path / "tiny_raft.pth")
    torch.save(model.state_dict(), path)
    argv = ["--cpu", "--tiny", "--iters", "2", "--weights", path,
            "--limit_samples", "3"]
    got, want = eval_on_sintel.main(argv), jeval.main(argv)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
