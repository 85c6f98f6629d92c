"""Write the image fixtures of the port's data layer into
``tests/fixtures/torch_coco/``, with OpenCV (run on a host that has cv2):

    python scripts/make_torch_coco_fixture.py

- JPEGs at COCO's sizes (long side 640 or 500, both orientations): baseline
  4:2:0, progressive, greyscale, 4:2:2 with restart markers;
- PNGs: 8-bit RGB, RGBA and grey, a 16-bit grey one (KITTI's disparity
  format) and a panoptic id PNG (id = R + 256 G + 256^2 B);
- ``corrupt.jpg``, a JPEG cut inside its header;
- ``decodes.npz``: what ``cv2.imread`` gives for each file, keyed
  ``<file>:<mode>`` with mode "color" (RGB), "gray" or "anydepth", each
  stored as differences along W (modulo its integer type), which deflate
  better; ``aloception_tpu_torch.utils.coco_fixture.read_decodes`` reads
  them back.

The images are smooth gradients and filled shapes from a seeded generator,
which keeps the files small. The card's decode gate (``chip_smoke.py``) and
``tests/test_torch_loader.py`` hold the port's decoder to these decodes.
"""

import os

import cv2
import numpy as np

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
                img = img[..., ::-1]
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
    record("rgb_120x160.png", (color,))
    alpha = rng.randint(0, 256, (120, 160, 1)).astype(np.uint8)
    cv2.imwrite(os.path.join(OUT, "rgba_120x160.png"),
                np.concatenate([scene(120, 160, rng), alpha], -1))
    record("rgba_120x160.png", (color,))
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
    np.savez_compressed(os.path.join(OUT, "decodes.npz"), **decodes)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(os.listdir(OUT))} files, {total / 2**20:.2f} MiB, to "
          f"{os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
