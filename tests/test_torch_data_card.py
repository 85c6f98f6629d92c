"""The data layer on the card: the fixtures decoded on the card machine
equal to the stored cv2 decodes, the pixel transforms on CUDA frames
against the same transforms on the CPU (1e-5 of max|ref|), the train
branch of ``fused_preprocess`` and ``device_pipeline`` to the card, and a
multi-scale batch of COCO on disk on the card. Card only: each test skips
without a CUDA card. Imports no JAX package (the card machine has jax but
no flax)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import aloception_tpu_torch.aloscene as tsc
from aloception_tpu_torch.alodataset import transforms as TT
from aloception_tpu_torch.runtime import NativeImageLoader, decode
from aloception_tpu_torch.utils.coco_fixture import read_decodes

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_coco"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_fixture_decodes_on_the_card_machine(cuda):
    for key, want in read_decodes(str(FIXTURES / "decodes.npz")).items():
        name, mode = key.split(":")
        got = decode(str(FIXTURES / name), mode).numpy()
        assert np.array_equal(got.reshape(want.shape), want), key


def frame(device, seed=0):
    rng = np.random.RandomState(seed)
    f = tsc.Frame(torch.from_numpy(
        rng.uniform(0, 255, (3, 96, 128)).astype(np.float32)))
    f.append_flow(tsc.Flow(torch.from_numpy(
        rng.uniform(-2, 2, (2, 96, 128)).astype(np.float32))))
    return f.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ColorJitter", "GrayScale",
                                  "RandomFocusBlurV2", "RandomFlowMotionBlur",
                                  "RandomCornersMask", "SpatialShift",
                                  "Rotate"])
def test_transform_on_the_card_matches_cpu(cuda, name):
    make = {"ColorJitter": lambda g: TT.ColorJitter(hue=0.3, generator=g),
            "GrayScale": lambda g: TT.GrayScale(generator=g),
            "RandomFocusBlurV2": lambda g: TT.RandomFocusBlurV2(generator=g),
            "RandomFlowMotionBlur": lambda g: TT.RandomFlowMotionBlur(
                generator=g),
            "RandomCornersMask": lambda g: TT.RandomCornersMask(generator=g),
            "SpatialShift": lambda g: TT.SpatialShift((0.1, 0.2),
                                                      generator=g),
            "Rotate": lambda g: TT.Rotate(7.0, generator=g)}[name]
    t = make(torch.Generator().manual_seed(1))
    params = t.sample_params()
    t.set_params(*params)
    want = t.apply(frame("cpu"))
    got = t.apply(frame(cuda))
    assert got.device.type == "cuda"
    ref = want.array
    err = float((got.array.cpu() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()) + 1e-5, err


@pytest.mark.cuda
def test_train_preprocess_on_the_card(cuda):
    from aloception_tpu_torch.ops.preprocess import (draw_jitter,
                                                     fused_preprocess, jitter)
    images = torch.randint(0, 256, (4, 64, 96, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(5)
    got, mask = fused_preprocess(images.to(cuda), out_size=(48, 64),
                                 dtype=torch.float32, train=True, generator=g)
    draws = draw_jitter(4, torch.Generator(device=cuda).manual_seed(5))
    ref = fused_preprocess(images, out_size=(48, 64), dtype=torch.float32)[0]
    mean = torch.tensor((0.485, 0.456, 0.406))
    std = torch.tensor((0.229, 0.224, 0.225))
    want = (jitter(ref * std + mean, *(d.cpu() for d in draws)) - mean) / std
    assert got.device.type == "cuda" and mask.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_device_pipeline_to_the_card(cuda):
    from aloception_tpu_torch.ops.preprocess import device_pipeline
    paths = sorted(str(p) for p in FIXTURES.glob("*.jpg")
                   if p.name != "corrupt.jpg")
    loader = NativeImageLoader((64, 96), "raw")
    (x, m), = list(device_pipeline([paths[:4]], loader, train=False,
                                   dtype=torch.float32))
    assert x.device.type == "cuda" and tuple(x.shape) == (4, 64, 96, 3)
    raw, _ = loader.load_batch(paths[:4])
    mean = torch.tensor((0.485, 0.456, 0.406))
    std = torch.tensor((0.229, 0.224, 0.225))
    want = (raw / 255.0 - mean) / std
    assert float((x.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_multiscale_batch_of_coco_on_disk(cuda, tmp_path, monkeypatch):
    import aloception_tpu_torch.alodataset.base_dataset as tbase
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train.trainer import to_device
    from aloception_tpu_torch.utils.coco_fixture import build_coco_dir
    jpegs = sorted(str(p) for p in FIXTURES.glob("*.jpg")
                   if p.name != "corrupt.jpg")
    root = build_coco_dir(str(tmp_path / "coco"), jpegs, n_train=4, n_val=2)
    monkeypatch.setattr(tbase, "CONFIG_PATH", str(tmp_path / "cfg.json"))
    dm = CocoDetection2Detr(size=None, batch_size=2, dataset_dir=root)
    batch = dm.prepare_batch(next(iter(dm.train_dataloader())))
    images, mask = to_device(batch["inputs"], cuda)
    assert images.device.type == "cuda" and images.shape[0] == 2
    assert 0 < float(mask.mean()) < 1 or float(mask.sum()) == 0
