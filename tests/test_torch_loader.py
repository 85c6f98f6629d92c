"""The port's image decoders (``aloception_tpu_torch/runtime``: Pillow for
JPEG and WebP, the native loader for PNG and BMP) against OpenCV and the JAX
package: decodes equal to ``cv2.imread`` (the fixtures' stored decodes and
seeded files of every JPEG, WebP, PNG and BMP variant), EXIF orientation,
the polygon fill equal to ``cv2.fillPoly``, decode + resize + normalize
equal to the JAX ``NativeImageLoader``, the failure mask, and the
``Frame(path)``, ``Mask(path)`` and PNG ``Disparity`` readers against the
JAX package's (tolerance 0: the same integers, the same float arithmetic)."""

import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import aloception_tpu.aloscene as jsc
import aloception_tpu_torch.aloscene as tsc
from aloception_tpu_torch.aloscene import InvalidSampleError
from aloception_tpu_torch.runtime import NativeImageLoader, decode, fill_poly
from aloception_tpu_torch.utils.coco_fixture import read_decodes

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_coco"
DECODES = read_decodes(str(FIXTURES / "decodes.npz"))
CV2_FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "anydepth": cv2.IMREAD_ANYDEPTH, "unchanged": cv2.IMREAD_UNCHANGED}


def cv2_read(path, mode="color"):
    """cv2.imread as the port returns it: (H, W, C), RGB(A) order."""
    img = cv2.imread(str(path), CV2_FLAGS[mode])
    assert img is not None, path
    if img.ndim == 2:
        return img[..., None]
    if img.shape[2] == 3:
        return img[..., ::-1]
    return img[..., [2, 1, 0, 3]]


def assert_same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("key", sorted(DECODES))
def test_fixture_decodes_equal_stored_cv2(key):
    name, mode = key.split(":")
    want = DECODES[key]
    assert_same(decode(str(FIXTURES / name), mode),
                want if want.ndim == 3 else want[..., None])
    assert_same(decode(str(FIXTURES / name), mode),
                cv2_read(FIXTURES / name, mode))


def scene(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h, (x * y) % 256.0], -1)
    img += rng.normal(0, 25, img.shape)
    cv2.circle(img, (w // 3, h // 2), max(1, min(h, w) // 4),
               (200, 30, 90), -1)
    return np.clip(img, 0, 255).astype(np.uint8)


JPEG_PARAMS = {
    "baseline": [],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "progressive_q98": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                        cv2.IMWRITE_JPEG_QUALITY, 98],
    "restart": [cv2.IMWRITE_JPEG_QUALITY, 50, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "s440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "s411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
}


@pytest.mark.parametrize("variant", sorted(JPEG_PARAMS))
@pytest.mark.parametrize("hw", [(37, 53), (64, 48), (2, 3), (1, 1)])
def test_jpeg_equals_cv2(tmp_path, variant, hw):
    img = scene(*hw, seed=hw[0])
    for grey in (False, True):
        src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if grey else img
        path = tmp_path / f"{variant}_{grey}.jpg"
        cv2.imwrite(str(path), src, JPEG_PARAMS[variant])
        for mode in ("color", "gray"):
            assert_same(decode(str(path), mode), cv2_read(path, mode))


def png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, rows, w, h, depth, ctype, plte=None, interlace=0):
    """A PNG of already-filtered-as-none rows (bytes each)."""
    raw = b"".join(b"\x00" + r for r in rows)
    data = (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
    if plte is not None:
        data += png_chunk(b"PLTE", plte)
    data += png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b"")
    Path(path).write_bytes(data)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_equals_cv2(tmp_path, dtype, channels):
    rng = np.random.RandomState(channels)
    hi = 256 if dtype == np.uint8 else 65536
    for hw in ((33, 47), (1, 1), (7, 3)):
        img = rng.randint(0, hi, hw + (channels,)).astype(dtype)
        path = tmp_path / f"{hw[0]}.png"
        cv2.imwrite(str(path), img if channels > 1 else img[..., 0],
                    [cv2.IMWRITE_PNG_COMPRESSION, int(rng.randint(10))])
        modes = ["color", "unchanged"] + (["gray", "anydepth"]
                                          if channels == 1 else [])
        for mode in modes:
            assert_same(decode(str(path), mode), cv2_read(path, mode))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_low_depth_grey_and_palette_png_equal_cv2(tmp_path, depth):
    rng = np.random.RandomState(depth)
    h, w = 13, 29
    values = rng.randint(0, 1 << depth, (h, w))
    rows = []
    for r in values:
        bits = "".join(format(int(v), f"0{depth}b") for v in r)
        bits += "0" * (-len(bits) % 8)
        rows.append(int(bits, 2).to_bytes(len(bits) // 8, "big"))
    write_png(tmp_path / "g.png", rows, w, h, depth, 0)
    for mode in ("color", "gray"):
        assert_same(decode(str(tmp_path / "g.png"), mode),
                    cv2_read(tmp_path / "g.png", mode))
    plte = rng.randint(0, 256, (1 << depth) * 3).astype(np.uint8).tobytes()
    write_png(tmp_path / "p.png", rows, w, h, depth, 3, plte=plte)
    assert_same(decode(str(tmp_path / "p.png")), cv2_read(tmp_path / "p.png"))


def test_interlaced_png_equals_cv2(tmp_path):
    rng = np.random.RandomState(0)
    h, w = 19, 23
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + r.tobytes() for r in sub)
    (tmp_path / "i.png").write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
        + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))
    assert_same(decode(str(tmp_path / "i.png")), img)
    assert_same(decode(str(tmp_path / "i.png")), cv2_read(tmp_path / "i.png"))


@pytest.mark.parametrize("grey", [False, True])
def test_bmp_equals_cv2(tmp_path, grey):
    img = scene(21, 31, seed=3)
    cv2.imwrite(str(tmp_path / "t.bmp"),
                cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if grey else img)
    assert_same(decode(str(tmp_path / "t.bmp")), cv2_read(tmp_path / "t.bmp"))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    cv2.imwrite(str(tmp_path / "e.jpg"), scene(24, 40, seed=5))
    data = (tmp_path / "e.jpg").read_bytes()
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    path = tmp_path / f"o{orientation}.jpg"
    path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
                     + app1 + data[2:])
    assert_same(decode(str(path)), cv2_read(path))


@pytest.mark.parametrize("seed", range(6))
def test_fill_poly_equals_cv2(seed):
    """Random polygons, inside the mask and across its border (the clipped
    edges), against cv2.fillPoly."""
    rng = np.random.RandomState(seed)
    for trial in range(300):
        h, w = rng.randint(4, 50), rng.randint(4, 50)
        k = rng.randint(3, 12)
        pad = 6 if trial % 3 == 0 else 0
        pts = np.stack([rng.uniform(-pad, w - 1 + pad, k),
                        rng.uniform(-pad, h - 1 + pad, k)], -1)
        ipts = np.round(pts).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [ipts], 1)
        got = fill_poly(np.zeros((h, w), np.uint8), ipts)
        assert np.array_equal(got, want), (seed, trial, (got != want).sum())


def test_corrupt_missing_and_webp_raise(tmp_path):
    with pytest.raises(InvalidSampleError, match="corrupt"):
        decode(str(FIXTURES / "corrupt.jpg"))
    with pytest.raises(InvalidSampleError, match="cannot read the file"):
        decode(str(tmp_path / "missing.jpg"))
    (tmp_path / "x.webp").write_bytes(b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8))
    with pytest.raises(InvalidSampleError, match="WebP"):
        decode(str(tmp_path / "x.webp"))
    (tmp_path / "x.txt").write_bytes(b"hello")
    with pytest.raises(InvalidSampleError, match="unknown format"):
        tsc.Frame(str(tmp_path / "x.txt"))
    with pytest.raises(jsc.InvalidSampleError):
        jsc.Frame(str(tmp_path / "x.txt"))


@pytest.mark.parametrize("quality", [80, 101])       # 101: lossless
def test_webp_equals_cv2(tmp_path, quality):
    """WebP, lossy and lossless, colour and as stored, equal to cv2.imread;
    a colour WebP read as grey raises (cv2's conversion is not Pillow's)."""
    path = tmp_path / "t.webp"
    cv2.imwrite(str(path), scene(37, 53, seed=quality)[..., ::-1],
                [cv2.IMWRITE_WEBP_QUALITY, quality])
    for mode in ("color", "unchanged"):
        assert_same(decode(str(path), mode), cv2_read(path, mode))
    with pytest.raises(InvalidSampleError, match="grey of a colour WebP"):
        decode(str(path), "gray")


def test_truncated_jpeg_raises(tmp_path):
    """A JPEG cut short raises, where cv2 returns it with grey rows."""
    data = (FIXTURES / "baseline_480x640.jpg").read_bytes()
    (tmp_path / "cut.jpg").write_bytes(data[:len(data) * 2 // 3])
    with pytest.raises(InvalidSampleError, match="corrupt JPEG"):
        decode(str(tmp_path / "cut.jpg"))


def fixture_images():
    return [str(FIXTURES / n) for n in sorted(os.listdir(FIXTURES))
            if n.endswith((".jpg", ".png")) and n != "corrupt.jpg"]


@pytest.mark.parametrize("mode", ["raw", "01", "resnet"])
def test_batch_loader_equals_jax(mode):
    """decode + bilinear resize + normalize of the fixtures, a missing file
    and the corrupt one: the same floats and ok-mask as the JAX loader
    (whose libjpeg/libpng decode equals cv2's here)."""
    from aloception_tpu.runtime.loader import NativeImageLoader as JaxLoader
    paths = fixture_images() + [str(FIXTURES / "missing.jpg"),
                                str(FIXTURES / "corrupt.jpg")]
    got, ok = NativeImageLoader((72, 100), mode=mode, n_threads=3
                                ).load_batch(paths)
    want, want_ok = JaxLoader((72, 100), mode=mode, n_threads=3
                              ).load_batch(paths)
    assert np.array_equal(ok.numpy(), want_ok)
    assert not ok[-2:].any() and ok[:-2].all()
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[-2:].abs().max()) == 0.0


def test_loader_load_raises_with_the_reason():
    with pytest.raises(InvalidSampleError, match="corrupt JPEG"):
        NativeImageLoader((8, 8)).load(str(FIXTURES / "corrupt.jpg"))


@pytest.mark.parametrize("name", [n for n in os.listdir(FIXTURES)
                                  if n.endswith((".jpg", ".png"))
                                  and n != "corrupt.jpg"])
def test_frame_from_path_equals_jax(name):
    path = str(FIXTURES / name)
    got, want = tsc.Frame(path), jsc.Frame(path)
    assert got.normalization == want.normalization == "255"
    assert got.names == tuple(want.names)
    np.testing.assert_array_equal(got.array.numpy(),
                                  np.asarray(want.as_numpy()))


@pytest.mark.parametrize("name", ["grey_96x128.png", "baseline_480x640.jpg",
                                  "grey_375x500.jpg"])
def test_mask_from_path_equals_jax(name):
    path = str(FIXTURES / name)
    got, want = tsc.Mask(path), jsc.Mask(path)
    assert got.names == tuple(want.names) == ("N", "H", "W")
    np.testing.assert_array_equal(got.array.numpy(),
                                  np.asarray(want.as_numpy()))


@pytest.mark.parametrize("negate", [False, True])
def test_png_disparity_equals_jax(negate):
    path = str(FIXTURES / "disp16_75x124.png")
    got = tsc.Disparity(path, png_negate=negate,
                        disp_format="signed" if negate else "unsigned",
                        camera_side="left" if negate else None)
    want = jsc.Disparity(path, png_negate=negate,
                         disp_format="signed" if negate else "unsigned",
                         camera_side="left" if negate else None)
    np.testing.assert_array_equal(got.array.numpy(),
                                  np.asarray(want.as_numpy()))
    assert float(got.array.abs().max()) > 20.0


def test_png_disparity_needs_png_negate():
    from aloception_tpu_torch.aloscene.io.disparity import load_disp
    with pytest.raises(ValueError, match="png_negate"):
        load_disp(str(FIXTURES / "disp16_75x124.png"))


def test_colour_png_as_mask_raises(tmp_path):
    """cv2's colour -> grey conversion of a PNG is not reproduced: the port
    refuses it rather than giving other values."""
    with pytest.raises(InvalidSampleError, match="colour PNG"):
        tsc.Mask(str(FIXTURES / "rgb_120x160.png"))

