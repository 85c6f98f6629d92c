"""Write the image fixtures of the port's data layer into
``tests/fixtures/torch_coco/``, with OpenCV (run on a host that has cv2):

    python scripts/make_torch_coco_fixture.py

- JPEGs at COCO's sizes (long side 640 or 500, both orientations): baseline
  4:2:0, progressive, greyscale, 4:2:2 with restart markers;
- PNGs: 8-bit RGB, RGBA and grey, a 16-bit grey one (KITTI's disparity
  format) and a panoptic id PNG (id = R + 256 G + 256^2 B);
- ``corrupt.jpg``, a JPEG cut inside its header;
- ``reads/``: the reads cv2 serves with a conversion of its own, each held
  against cv2's decode: a baseline and a progressive JPEG cut short (cv2
  decodes the rows that arrived, then libjpeg's fill), a CMYK JPEG
  (written by Pillow, with Adobe's marker), colour WebPs with and without
  alpha, a 16-bit colour PNG, a colour PNG with an sRGB chunk (libpng's
  gamma tables), a grey + alpha PNG, and 24-bit, 32-bit (bit fields) and
  palette BMPs, read as grey and as stored; 16-bit RGB and RGBA PNGs read
  as grey under several gAMA values, sRGB, sRGB beside a gAMA (either
  order), an sBIT, ICC profiles (an sRGB one made by Little CMS, and
  another) and a cICP chunk (libpng's 16-bit gamma tables and its choice
  of the file gamma); 32-bit bit-field BMPs with and without an alpha mask
  read as stored;
- ``decodes.npz``: what ``cv2.imread`` gives for each file, keyed
  ``<file>:<mode>`` with mode "color" (RGB), "gray", "anydepth" or
  "unchanged" (RGB(A) order), each
  stored as differences along W (modulo its integer type), which deflate
  better; ``aloception_tpu_torch.utils.coco_fixture.read_decodes`` reads
  them back.

The images are smooth gradients and filled shapes from a seeded generator,
which keeps the files small. The card's decode gate (``chip_smoke.py``) and
``tests/test_torch_loader.py`` hold the port's decoder to these decodes.
"""

import os
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "fixtures", "torch_coco")

Q75 = [cv2.IMWRITE_JPEG_QUALITY, 75]
# name: (H, W, cv2.imwrite parameters, grey)
JPEGS = {
    "baseline_480x640.jpg": (480, 640, Q75, False),
    "baseline_640x480.jpg": (640, 480, Q75, False),
    "progressive_427x640.jpg": (427, 640, Q75 + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                                False),
    "progressive_640x427.jpg": (640, 427, Q75 + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                                False),
    "grey_375x500.jpg": (375, 500, Q75, True),
    "s422_rst_500x375.jpg": (500, 375, Q75 + [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 5], False),
}

# the JPEGs whose grey decode (the luma plane) is kept too
GREY_DECODED = ("baseline_480x640.jpg", "grey_375x500.jpg")


def scene(h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """(h, w, 3) uint8 BGR: two gradients and a few filled shapes."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b = rng.uniform(0.2, 1.0, 2)
    img = np.stack([255 * x / w * a, 255 * y / h * b,
                    127 + 100 * np.sin((x + y) / rng.uniform(40, 90))], -1)
    img = img.astype(np.uint8)
    for _ in range(rng.randint(3, 7)):
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        if rng.rand() < 0.5:
            cv2.circle(img, (int(rng.randint(w)), int(rng.randint(h))),
                       int(rng.randint(10, min(h, w) // 4)), color, -1)
        else:
            pts = np.stack([rng.randint(0, w, 5), rng.randint(0, h, 5)], -1)
            cv2.fillPoly(img, [pts.astype(np.int32)], color)
    return img


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.RandomState(2024)
    decodes = {}

    def record(name, modes):
        path = os.path.join(OUT, name)
        for mode, flag in modes:
            img = cv2.imread(path, flag)
            if img is None:
                raise RuntimeError(f"cv2 cannot read {path}")
            if img.ndim == 3:
                img = img[..., [2, 1, 0, 3][:img.shape[2]]]
            decodes[f"{name}:{mode}"] = np.diff(img, axis=1, prepend=0
                                                ).astype(img.dtype)

    color = ("color", cv2.IMREAD_COLOR)
    gray = ("gray", cv2.IMREAD_GRAYSCALE)
    anydepth = ("anydepth", cv2.IMREAD_ANYDEPTH)
    for name, (h, w, params, grey) in JPEGS.items():
        img = scene(h, w, rng)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(os.path.join(OUT, name), img, params)
        record(name, (color, gray) if name in GREY_DECODED else (color,))

    img = scene(120, 160, rng)
    cv2.imwrite(os.path.join(OUT, "rgb_120x160.png"), img)
    record("rgb_120x160.png", (color, gray))
    alpha = rng.randint(0, 256, (120, 160, 1)).astype(np.uint8)
    cv2.imwrite(os.path.join(OUT, "rgba_120x160.png"),
                np.concatenate([scene(120, 160, rng), alpha], -1))
    record("rgba_120x160.png", (color, gray))
    cv2.imwrite(os.path.join(OUT, "grey_96x128.png"),
                cv2.cvtColor(scene(96, 128, rng), cv2.COLOR_BGR2GRAY))
    record("grey_96x128.png", (color, gray))
    y, x = np.mgrid[0:75, 0:124]
    disp = (256 * (20 + 40 * x / 124 + 10 * np.sin(y / 9))).astype(np.uint16)
    cv2.imwrite(os.path.join(OUT, "disp16_75x124.png"), disp)
    record("disp16_75x124.png", (color, anydepth))
    ids = np.zeros((96, 128), np.int64)
    ids[:32] = 3 + 256 * 7
    ids[64:] = 12 + 256 * 200 + 65536 * 5
    disc = np.zeros((96, 128), np.uint8)
    cv2.circle(disc, (60, 50), 15, 1, -1)
    ids[disc > 0] = 900001
    rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1)
    cv2.imwrite(os.path.join(OUT, "panoptic_96x128.png"),
                rgb.astype(np.uint8)[..., ::-1])
    record("panoptic_96x128.png", (color,))

    with open(os.path.join(OUT, "baseline_480x640.jpg"), "rb") as f:
        head = f.read(300)
    with open(os.path.join(OUT, "corrupt.jpg"), "wb") as f:
        f.write(head[:120])
    reads(np.random.RandomState(2025), record)
    gamma_reads(np.random.RandomState(2026), record)
    np.savez_compressed(os.path.join(OUT, "decodes.npz"), **decodes)
    files = [os.path.join(d, n) for d, _, names in os.walk(OUT)
             for n in names]
    total = sum(os.path.getsize(f) for f in files)
    print(f"wrote {len(files)} files, {total / 2**20:.2f} MiB, to "
          f"{os.path.normpath(OUT)}")


def png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def bmp_bytes(rows, w: int, h: int, bits: int, palette: bytes = b"") -> bytes:
    """An uncompressed bottom-up BMP with a 40-byte header."""
    stride = (w * bits + 31) // 32 * 4
    data = b"".join(r.ljust(stride, b"\0") for r in rows[::-1])
    off = 54 + len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, len(data), 2835,
                       2835, len(palette) // 4, 0)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + palette + data)


def reads(rng: np.random.RandomState, record):
    """The files of ``reads/`` and their cv2 decodes."""
    os.makedirs(os.path.join(OUT, "reads"), exist_ok=True)

    def path(name):
        return os.path.join(OUT, "reads", name)

    color = ("color", cv2.IMREAD_COLOR)
    gray = ("gray", cv2.IMREAD_GRAYSCALE)
    anydepth = ("anydepth", cv2.IMREAD_ANYDEPTH)
    unchanged = ("unchanged", cv2.IMREAD_UNCHANGED)
    for name, frac in (("baseline_480x640.jpg", 2 / 3),
                       ("progressive_427x640.jpg", 1 / 2)):
        with open(os.path.join(OUT, name), "rb") as f:
            data = f.read()
        with open(path(f"cut_{name}"), "wb") as f:
            f.write(data[:int(len(data) * frac)])
        record(f"reads/cut_{name}", (color, gray))
    # Pillow writes CMYK with Adobe's marker, inverted as Adobe stores it
    cmyk = np.concatenate([scene(120, 160, rng),
                           rng.randint(0, 120, (120, 160, 1))], -1)
    Image.fromarray(cmyk.astype(np.uint8), "CMYK").save(
        path("cmyk_120x160.jpg"), quality=90)
    record("reads/cmyk_120x160.jpg", (color, gray, unchanged))
    img = scene(120, 160, rng)
    cv2.imwrite(path("rgb_120x160.webp"), img, [cv2.IMWRITE_WEBP_QUALITY, 80])
    record("reads/rgb_120x160.webp", (gray, anydepth))
    alpha = rng.randint(0, 256, (120, 160, 1)).astype(np.uint8)
    cv2.imwrite(path("rgba_120x160.webp"),
                np.concatenate([scene(120, 160, rng), alpha], -1),
                [cv2.IMWRITE_WEBP_QUALITY, 101])
    record("reads/rgba_120x160.webp", (gray, unchanged))
    y, x = np.mgrid[0:60, 0:80]
    rgb16 = np.stack([x * 800, y * 1000, (x * y * 37) % 65536], -1)
    rgb16[:4] = rgb16[:4, :, :1]          # equal samples stay as they are
    cv2.imwrite(path("rgb16_60x80.png"), rgb16.astype(np.uint16))
    record("reads/rgb16_60x80.png", (gray, anydepth))
    # an sRGB chunk gives libpng a gamma: its rgb_to_gray goes through tables
    cv2.imwrite(path("srgb_120x160.png"), scene(120, 160, rng))
    with open(path("srgb_120x160.png"), "rb") as f:
        data = f.read()
    with open(path("srgb_120x160.png"), "wb") as f:
        f.write(data[:33] + png_chunk(b"sRGB", b"\0") + data[33:])
    record("reads/srgb_120x160.png", (color, gray))
    grey = cv2.cvtColor(scene(96, 128, rng), cv2.COLOR_BGR2GRAY)
    ga = np.stack([grey, rng.randint(0, 256, (96, 128)).astype(np.uint8)], -1)
    raw = b"".join(b"\0" + r.tobytes() for r in ga)
    with open(path("ga_96x128.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 128, 96, 8, 4, 0,
                                                 0, 0))
                + png_chunk(b"IDAT", zlib.compress(raw))
                + png_chunk(b"IEND", b""))
    record("reads/ga_96x128.png", (color, gray, unchanged))
    cv2.imwrite(path("rgb_120x160.bmp"), scene(120, 160, rng))
    record("reads/rgb_120x160.bmp", (gray, anydepth))
    # cv2 writes 4 channels as 32 bits with bit fields and a 124-byte header
    cv2.imwrite(path("bgra_120x160.bmp"), np.concatenate(
        [scene(120, 160, rng), alpha], -1))
    record("reads/bgra_120x160.bmp", (color, gray, unchanged))
    palette = rng.randint(0, 256, (256, 4)).astype(np.uint8)
    palette[:, 3] = 0
    index = rng.randint(0, 256, (96, 128)).astype(np.uint8)
    with open(path("palette_96x128.bmp"), "wb") as f:
        f.write(bmp_bytes([r.tobytes() for r in index], 128, 96, 8,
                          palette.tobytes()))
    record("reads/palette_96x128.bmp", (color, gray))


def png_bytes(img: np.ndarray, ctype: int, chunks: bytes = b"") -> bytes:
    """A 16-bit PNG of (H, W, C) samples, ``chunks`` after its header."""
    h, w = img.shape[:2]
    raw = b"".join(b"\0" + r.tobytes() for r in img.astype(">u2"))
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0,
                                             0, 0))
            + chunks + png_chunk(b"IDAT", zlib.compress(raw, 9))
            + png_chunk(b"IEND", b""))


def icc_profiles():
    """Little CMS's sRGB profile (its date and ID zeroed, so the bytes do not
    change from run to run) and an RGB profile that is not sRGB: the same
    with another red primary."""
    from PIL import ImageCms
    srgb = bytearray(ImageCms.ImageCmsProfile(
        ImageCms.createProfile("sRGB")).tobytes())
    srgb[24:36] = bytes(12)
    srgb[84:100] = bytes(16)
    other = bytearray(srgb)
    count = struct.unpack(">I", srgb[128:132])[0]
    for k in range(count):
        sig, off, _ = struct.unpack(">4sII", srgb[132 + 12 * k:144 + 12 * k])
        if sig == b"rXYZ":
            other[off + 8:off + 12] = struct.pack(">i", 0x8000)  # X = 0.5
    return bytes(srgb), bytes(other)


def gamma_reads(rng: np.random.RandomState, record):
    """16-bit colour PNGs read as grey with libpng's file gamma from each
    chunk that may give one, and 32-bit bit-field BMPs read as stored."""
    def path(name):
        return os.path.join(OUT, "reads", name)

    gray = ("gray", cv2.IMREAD_GRAYSCALE)
    anydepth = ("anydepth", cv2.IMREAD_ANYDEPTH)
    unchanged = ("unchanged", cv2.IMREAD_UNCHANGED)

    def gama(g):
        return png_chunk(b"gAMA", struct.pack(">I", g))

    srgb_chunk = png_chunk(b"sRGB", b"\0")
    srgb_icc, other_icc = icc_profiles()

    def iccp(profile):
        return png_chunk(b"iCCP", b"ICC\0\0" + zlib.compress(profile, 9))

    cases = {
        "gama45455": gama(45455), "gama55000": gama(55000),
        "gama220000": gama(220000), "gama94000": gama(94000),
        "srgb": srgb_chunk, "gama55000_srgb": gama(55000) + srgb_chunk,
        "srgb_gama220000": srgb_chunk + gama(220000),
        "sbit12_gama55000": png_chunk(b"sBIT", bytes([12, 11, 12]))
        + gama(55000),
        "iccp_srgb": iccp(srgb_icc), "iccp_other": iccp(other_icc),
        "iccp_other_gama55000": iccp(other_icc) + gama(55000),
        "cicp_srgb": png_chunk(b"cICP", bytes([1, 13, 0, 1])),
        "cicp_linear_gama55000": png_chunk(b"cICP", bytes([1, 8, 0, 1]))
        + gama(55000),
    }
    for name, chunks in cases.items():
        for ctype in (2, 6) if name in ("gama45455", "srgb") else (2,):
            img = rng.randint(0, 65536, (24, 32, 4 if ctype == 6 else 3))
            img[:3, :, 1:3] = img[:3, :, :1]        # equal samples
            file = f"rgb{'a' if ctype == 6 else ''}16_{name}_24x32.png"
            with open(path(file), "wb") as f:
                f.write(png_bytes(img, ctype, chunks))
            record(f"reads/{file}", (gray, anydepth))
    # 32 bits with bit fields: no alpha mask in a 40-byte header (the fourth
    # byte is cv2's alpha), an alpha mask of 0 in a 124-byte one (255)
    bgra = rng.randint(0, 256, (20, 28, 4)).astype(np.uint8)
    masks = struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0)
    for name, hsize in (("fields40", 40), ("fields124_noalpha", 124)):
        stride = 28 * 4
        data = b"".join(r.tobytes() for r in bgra[::-1])
        info = struct.pack("<IiiHHIIiiII", hsize, 28, 20, 1, 32, 3,
                           stride * 20, 2835, 2835, 0, 0)
        info = info + masks[:12] if hsize == 40 else (info + masks).ljust(
            hsize, b"\0")
        off = 14 + len(info)
        with open(path(f"bgra_{name}_20x28.bmp"), "wb") as f:
            f.write(b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
                    + info + data)
        record(f"reads/bgra_{name}_20x28.bmp", (unchanged, gray))


if __name__ == "__main__":
    main()
