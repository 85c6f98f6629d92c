"""The port's image decoders (``aloception_tpu_torch/runtime``: Pillow for
JPEG and WebP, the native loader for PNG and BMP) against OpenCV and the JAX
package: decodes equal to ``cv2.imread`` (the fixtures' stored decodes and
seeded files of every JPEG, WebP, PNG and BMP variant), EXIF orientation,
the polygon fill equal to ``cv2.fillPoly``, decode + resize + normalize
equal to the JAX ``NativeImageLoader``, the failure mask, and the
``Frame(path)``, ``Mask(path)`` and PNG ``Disparity`` readers against the
JAX package's (tolerance 0: the same integers, the same float arithmetic).
The reads cv2 serves with conversions of its own (truncated and CMYK JPEGs,
colour WebP, PNG and BMP read as grey, grey + alpha PNG as stored) are held
bit-equal to cv2 too."""

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
        for mode in ("color", "unchanged", "gray", "anydepth"):
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
    """8-bit (grey palette) and 24-bit BMPs, in colour and read as grey
    (cv2's 14-bit fixed point)."""
    img = scene(21, 31, seed=3)
    cv2.imwrite(str(tmp_path / "t.bmp"),
                cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if grey else img)
    for mode in ("color", "gray", "anydepth"):
        assert_same(decode(str(tmp_path / "t.bmp"), mode),
                    cv2_read(tmp_path / "t.bmp", mode))


def bmp_file(path, img, bits, hsize=40, comp=0, palette=b""):
    """A bottom-up BMP of (H, W, bytes a pixel) uint8 rows as stored; with
    bit fields (comp 3) the standard BGRA masks, in the header from 52
    bytes on (the alpha mask from 56), else after it."""
    h, w = img.shape[:2]
    stride = (w * bits + 31) // 32 * 4
    data = b"".join(r.tobytes().ljust(stride, b"\0") for r in img[::-1])
    masks = struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    info = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bits, comp, len(data),
                       2835, 2835, len(palette) // 4, 0)
    if hsize >= 52:
        info = (info + masks)[:hsize].ljust(hsize, b"\0")
    elif comp == 3:
        info += masks[:12]
    off = 14 + len(info) + len(palette)
    Path(path).write_bytes(b"BM" + struct.pack("<IHHI", off + len(data), 0, 0,
                                               off) + info + palette + data)


@pytest.mark.parametrize("layout", ["palette", "bgr", "bgrx", "fields40",
                                    "fields52", "fields56", "fields124"])
def test_bmp_as_grey_equals_cv2(tmp_path, layout):
    """A colour palette, 24 and 32 bits, read as grey: cv2 turns each row
    grey as it decodes, with the 14-bit fixed point, or, for 32 bits with
    bit fields in a header that holds an alpha mask (56 bytes or more), a
    float32 sum it truncates."""
    rng = np.random.RandomState(len(layout))
    kw = {"palette": dict(bits=8), "bgr": dict(bits=24),
          "bgrx": dict(bits=32), "fields40": dict(bits=32, comp=3),
          "fields52": dict(bits=32, comp=3, hsize=52),
          "fields56": dict(bits=32, comp=3, hsize=56),
          "fields124": dict(bits=32, comp=3, hsize=124)}[layout]
    if layout == "palette":
        pal = rng.randint(0, 256, (256, 4)).astype(np.uint8)
        pal[:, 3] = 0
        img = rng.randint(0, 256, (23, 37, 1)).astype(np.uint8)
        kw["palette"] = pal.tobytes()
    else:
        img = rng.randint(0, 256, (23, 37, kw["bits"] // 8)).astype(np.uint8)
    bmp_file(tmp_path / "t.bmp", img, **kw)
    for mode in ("color", "gray", "anydepth"):
        assert_same(decode(str(tmp_path / "t.bmp"), mode),
                    cv2_read(tmp_path / "t.bmp", mode))


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
    """WebP, lossy and lossless, with and without alpha, in colour, as
    stored and read as grey (cv2 decodes in colour, then its 15-bit
    ``cvtColor``), equal to cv2.imread."""
    img = scene(37, 53, seed=quality)[..., ::-1]
    alpha = np.random.RandomState(quality).randint(0, 256, img.shape[:2])
    for name, src in (("t.webp", img), ("a.webp", np.concatenate(
            [img, alpha[..., None].astype(np.uint8)], -1))):
        path = tmp_path / name
        cv2.imwrite(str(path), src, [cv2.IMWRITE_WEBP_QUALITY, quality])
        for mode in ("color", "unchanged", "gray", "anydepth"):
            assert_same(decode(str(path), mode), cv2_read(path, mode))


def test_truncated_jpeg_raises(tmp_path):
    """A JPEG cut inside its header raises, as cv2 returns nothing for it;
    one cut after its header decodes as cv2's does (the rows that arrived,
    then libjpeg's fill), in colour and grey, baseline and progressive, at
    cuts every ~1/40 of the file."""
    with pytest.raises(InvalidSampleError, match="corrupt JPEG"):
        decode(str(FIXTURES / "corrupt.jpg"))
    for name in ("baseline_480x640.jpg", "progressive_640x427.jpg"):
        data = (FIXTURES / name).read_bytes()
        for cut in range(len(data) // 40, len(data), len(data) // 40):
            path = tmp_path / f"cut{cut}.jpg"
            path.write_bytes(data[:cut])
            for mode in ("color", "gray"):
                want = cv2.imread(str(path), CV2_FLAGS[mode])
                if want is None:
                    with pytest.raises(InvalidSampleError):
                        decode(str(path), mode)
                    continue
                assert_same(decode(str(path), mode), cv2_read(path, mode))


def test_jpeg_reaches_pillow_with_an_eoi(tmp_path):
    """A whole JPEG with bytes after its EOI, and one whose data ends in a
    stuffed 0xFF, decode as cv2's; Pillow's process-wide
    ``LOAD_TRUNCATED_IMAGES`` stays off."""
    from PIL import ImageFile
    data = (FIXTURES / "baseline_480x640.jpg").read_bytes()
    (tmp_path / "tail.jpg").write_bytes(data + b"\x00" * 7)
    assert_same(decode(str(tmp_path / "tail.jpg")),
                cv2_read(tmp_path / "tail.jpg"))
    cut = data.index(b"\xff\x00", len(data) // 2) + 1
    (tmp_path / "ff.jpg").write_bytes(data[:cut])
    assert_same(decode(str(tmp_path / "ff.jpg")), cv2_read(tmp_path / "ff.jpg"))
    assert not ImageFile.LOAD_TRUNCATED_IMAGES


@pytest.mark.parametrize("adobe", [True, False])
def test_cmyk_jpeg_equals_cv2(tmp_path, adobe):
    """CMYK JPEGs through cv2's CMYK -> BGR of libjpeg's output (Adobe's
    inverted convention), and its grey of that; with and without Adobe's
    marker (libjpeg and Pillow treat the samples alike either way)."""
    from PIL import Image
    rng = np.random.RandomState(7)
    cmyk = rng.randint(0, 256, (29, 41, 4)).astype(np.uint8)
    cmyk[..., 3] //= 2
    path = tmp_path / "c.jpg"
    Image.fromarray(cmyk, "CMYK").save(path, quality=92)
    if not adobe:        # drop the APP14 "Adobe" segment
        data = path.read_bytes()
        at = data.index(b"Adobe") - 4           # FF EE, then the length
        assert data[at:at + 2] == b"\xff\xee"
        n = struct.unpack(">H", data[at + 2:at + 4])[0]
        path.write_bytes(data[:at] + data[at + 2 + n:])
        assert b"Adobe" not in path.read_bytes()
    for mode in ("color", "gray", "anydepth", "unchanged"):
        assert_same(decode(str(path), mode), cv2_read(path, mode))


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
    """A colour PNG read as a mask goes through libpng's rgb_to_gray as
    cv2 sets it up, equal to the JAX package's Mask; a 16-bit colour PNG
    with a gamma, or with an ICC profile (libpng takes no gamma from it),
    reads as cv2 reads it; a colour PNG whose image data is cut short
    raises."""
    path = str(FIXTURES / "rgb_120x160.png")
    np.testing.assert_array_equal(tsc.Mask(path).array.numpy(),
                                  np.asarray(jsc.Mask(path).as_numpy()))
    rgb16 = np.random.RandomState(0).randint(0, 65536, (5, 6, 3))
    cv2.imwrite(str(tmp_path / "c.png"), rgb16.astype(np.uint16))
    data = (tmp_path / "c.png").read_bytes()
    for tag, body in ((b"gAMA", struct.pack(">I", 45455)),
                      (b"iCCP", b"x\x00\x00" + zlib.compress(b"icc"))):
        (tmp_path / "g.png").write_bytes(data[:33] + png_chunk(tag, body)
                                         + data[33:])
        for mode in ("gray", "anydepth", "unchanged"):
            assert_same(decode(str(tmp_path / "g.png"), mode),
                        cv2_read(tmp_path / "g.png", mode))
    idat = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[idat:idat + 4])[0]
    body = data[idat + 8:idat + 8 + n][:n // 2]
    (tmp_path / "cut.png").write_bytes(data[:idat] + png_chunk(b"IDAT", body)
                                       + png_chunk(b"IEND", b""))
    with pytest.raises(InvalidSampleError, match="inflate"):
        tsc.Mask(str(tmp_path / "cut.png"))


@pytest.mark.parametrize("chunk", ["none", "gAMA 0.45455", "gAMA 0.55",
                                   "gAMA 1.0", "gAMA 2.2", "sRGB"])
@pytest.mark.parametrize("ctype", [2, 3, 6])
def test_colour_png_as_grey_equals_cv2(tmp_path, chunk, ctype):
    """RGB, palette and RGBA PNGs at 8 bits read as grey: libpng's
    rgb_to_gray with cv2's coefficients, truncating without a gamma, through
    its 8-bit gamma tables with one (gAMA far from 1, or sRGB)."""
    rng = np.random.RandomState(ctype)
    h, w = 17, 29
    if ctype == 3:
        img = rng.randint(0, 256, (h, w)).astype(np.uint8)
        plte = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    else:
        img = rng.randint(0, 256, (h, w, 3 if ctype == 2 else 4))
        img[:2, :, 1:3] = img[:2, :, :1]        # equal samples stay
        img, plte = img.astype(np.uint8), None
    extra = b""
    if chunk == "sRGB":
        extra = png_chunk(b"sRGB", b"\x00")
    elif chunk != "none":
        extra = png_chunk(b"gAMA", struct.pack(
            ">I", round(1e5 * float(chunk.split()[1]))))
    raw = b"".join(b"\x00" + r.tobytes() for r in img)
    data = (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0)) + extra)
    if plte is not None:
        data += png_chunk(b"PLTE", plte)
    data += png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b"")
    (tmp_path / "c.png").write_bytes(data)
    for mode in ("gray", "anydepth", "color"):
        assert_same(decode(str(tmp_path / "c.png"), mode),
                    cv2_read(tmp_path / "c.png", mode))


PNG16_CHUNKS = {
    "gAMA 0.45455": [(b"gAMA", struct.pack(">I", 45455))],
    "gAMA 0.3": [(b"gAMA", struct.pack(">I", 30000))],
    "gAMA 0.94": [(b"gAMA", struct.pack(">I", 94000))],
    "gAMA 1.2": [(b"gAMA", struct.pack(">I", 120000))],
    "sRGB": [(b"sRGB", b"\x00")],
    "gAMA then sRGB": [(b"gAMA", struct.pack(">I", 55000)),
                       (b"sRGB", b"\x00")],
    "sRGB then gAMA": [(b"sRGB", b"\x00"),
                       (b"gAMA", struct.pack(">I", 220000))],
    "sBIT 10,12,9": [(b"sBIT", bytes([10, 12, 9])),
                     (b"gAMA", struct.pack(">I", 55000))],
    "sBIT 4": [(b"sBIT", bytes([4, 4, 4])), (b"gAMA", struct.pack(">I", 55000))],
    "iCCP": [(b"iCCP", b"p\x00\x00" + zlib.compress(b"not a profile"))],
    "iCCP, sRGB": [(b"iCCP", b"p\x00\x00" + zlib.compress(b"icc")),
                   (b"sRGB", b"\x00")],
    "cICP": [(b"cICP", bytes([1, 13, 0, 1]))],
    "cICP, gAMA": [(b"cICP", bytes([1, 8, 0, 1])),
                   (b"gAMA", struct.pack(">I", 55000))],
}


@pytest.mark.parametrize("chunks", sorted(PNG16_CHUNKS))
@pytest.mark.parametrize("ctype", [2, 6])
def test_colour_png16_as_grey_equals_cv2(tmp_path, chunks, ctype):
    """16-bit RGB and RGBA PNGs read as grey, cut to 8 bits and at 16:
    libpng's 16-bit gamma tables (their index shifted by the bits sBIT or
    the cut to 8 bits leave out), its rounding of equal samples to 8 bits,
    and its file gamma: sRGB over a gAMA in either order, none from an iCCP
    or a cICP chunk."""
    rng = np.random.RandomState(ctype)
    img = rng.randint(0, 65536, (13, 21, 3 if ctype == 2 else 4))
    img[:2, :, 1:3] = img[:2, :, :1]
    raw = b"".join(b"\x00" + r.tobytes() for r in img.astype(">u2"))
    (tmp_path / "c.png").write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 21, 13, 16, ctype, 0, 0,
                                         0))
        + b"".join(png_chunk(t, d) for t, d in PNG16_CHUNKS[chunks])
        + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))
    for mode in ("gray", "anydepth", "color"):
        assert_same(decode(str(tmp_path / "c.png"), mode),
                    cv2_read(tmp_path / "c.png", mode))


@pytest.mark.parametrize("hsize,alpha_mask", [
    (40, None), (52, None), (56, 0xFF000000), (56, 0), (108, 0xFF),
    (124, 0), (124, 0xFF0000)])
def test_bmp_bit_fields_unchanged_equals_cv2(tmp_path, hsize, alpha_mask):
    """A 32-bit BMP with bit fields read as stored keeps 4 channels, as cv2
    does: the fourth byte without an alpha mask in the header, the masked
    byte with one, 255 where the mask is 0; a mask that is not one byte
    raises."""
    img = np.random.RandomState(hsize).randint(0, 256, (11, 13, 4)).astype(
        np.uint8)
    bmp_file(tmp_path / "t.bmp", img, 32, hsize=hsize, comp=3)
    if alpha_mask is not None:
        data = bytearray((tmp_path / "t.bmp").read_bytes())
        data[14 + 52:14 + 56] = struct.pack("<I", alpha_mask)
        (tmp_path / "t.bmp").write_bytes(bytes(data))
    for mode in ("unchanged", "color", "gray"):
        assert_same(decode(str(tmp_path / "t.bmp"), mode),
                    cv2_read(tmp_path / "t.bmp", mode))
    data = bytearray((tmp_path / "t.bmp").read_bytes())
    if hsize >= 56:
        data[14 + 52:14 + 56] = struct.pack("<I", 0xF0F00000)
        (tmp_path / "odd.bmp").write_bytes(bytes(data))
        with pytest.raises(InvalidSampleError, match="alpha mask"):
            decode(str(tmp_path / "odd.bmp"), "unchanged")


@pytest.mark.parametrize("depth", [8, 16])
def test_grey_alpha_png_unchanged_equals_cv2(tmp_path, depth):
    """A grey + alpha PNG read as stored: cv2 gives RGBA with the grey in
    each colour channel, at the stored depth."""
    rng = np.random.RandomState(depth)
    ga = rng.randint(0, 1 << depth, (9, 14, 2)).astype(
        np.uint8 if depth == 8 else ">u2")
    raw = b"".join(b"\x00" + r.tobytes() for r in ga)
    (tmp_path / "ga.png").write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 14, 9, depth, 4, 0, 0, 0))
        + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))
    for mode in ("unchanged", "color", "gray", "anydepth"):
        assert_same(decode(str(tmp_path / "ga.png"), mode),
                    cv2_read(tmp_path / "ga.png", mode))

