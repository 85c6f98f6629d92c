"""Seeded COCO-format directories over a folder of images, for tests and
smoke runs: detection (``instances_*.json``), panoptic
(``panoptic_*.json`` and id-encoded PNGs) and LVIS (``lvis_v1_*.json``).

The annotations follow COCO's conventions: its 80 category ids (1-90, with
gaps) and names, float polygons in absolute pixels (some touching or
leaving the image border), xywh boxes that enclose them, 1-40 objects an
image, and one crowd object as an uncompressed RLE. Images are copied from
``src`` (JPEGs decoded for their size by the port's loader).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Sequence, Tuple

import numpy as np

COCO_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90)
COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush")
CATEGORIES = [{"id": i, "name": n, "supercategory": "object"}
              for i, n in zip(COCO_IDS, COCO_NAMES)]


def read_decodes(path: str) -> Dict[str, np.ndarray]:
    """The reference decodes that ``scripts/make_torch_coco_fixture.py``
    stored (differences along W, modulo the integer type), summed back:
    ``{"<file>:<mode>": (H, W[, C]) array}``."""
    with np.load(path) as npz:
        return {k: np.cumsum(npz[k], axis=1, dtype=npz[k].dtype)
                for k in npz.files}


def image_size(path: str) -> Tuple[int, int]:
    """(H, W) of an image file, by the port's decoder."""
    from ..runtime import decode
    h, w, _ = decode(path, "unchanged").shape
    return h, w


def random_polygon(rng: np.random.RandomState, h: int, w: int) -> List[float]:
    """A star-shaped polygon of 3-12 float vertices [x0, y0, x1, ...]; about
    one in five reaches past the border, clamped onto it as COCO's are."""
    k = rng.randint(3, 13)
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    r = rng.uniform(8, max(9.0, min(h, w) / 3))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = r * rng.uniform(0.4, 1.0, k)
    xs = np.clip(cx + rad * np.cos(ang), 0, w)
    ys = np.clip(cy + rad * np.sin(ang), 0, h)
    return [round(float(v), 2) for xy in zip(xs, ys) for v in xy]


def rle_of(mask: np.ndarray) -> Dict:
    """Uncompressed COCO RLE (column-major counts, first run of zeros)."""
    flat = mask.T.reshape(-1).astype(np.int8)
    change = np.flatnonzero(np.diff(flat)) + 1     # starts of the runs
    counts = np.diff(np.concatenate([[0], change, [len(flat)]])).tolist()
    if flat[0] == 1:            # the first run counts zeros
        counts = [0] + counts
    return {"counts": counts, "size": [int(mask.shape[0]), int(mask.shape[1])]}


def _bbox(poly: Sequence[float]) -> List[float]:
    xs, ys = poly[0::2], poly[1::2]
    return [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]


def _copy_images(src: Sequence[str], folder: str, n: int
                 ) -> List[Tuple[int, str, int, int]]:
    """Copy ``n`` images, cycling over ``src``, as <id>.<ext> files; returns
    (id, file name, H, W)."""
    os.makedirs(folder, exist_ok=True)
    out = []
    for k in range(n):
        path = src[k % len(src)]
        img_id = k + 1
        name = f"{img_id:012d}{os.path.splitext(path)[1]}"
        shutil.copyfile(path, os.path.join(folder, name))
        out.append((img_id, name) + image_size(path))
    return out


def build_coco_dir(root: str, src: Sequence[str], seed: int = 0,
                   n_train: int = 16, n_val: int = 6,
                   objects: Tuple[int, int] = (1, 40)) -> str:
    """COCO detection at ``root``: ``train2017/``, ``val2017/`` and
    ``annotations/instances_{train,val}2017.json`` over copies of the images
    ``src``. The first train image holds the crowd object."""
    rng = np.random.RandomState(seed)
    ann_id = 1
    for split, n in (("train", n_train), ("val", n_val)):
        images, anns = [], []
        for img_id, name, h, w in _copy_images(
                src, os.path.join(root, f"{split}2017"), n):
            images.append({"id": img_id, "file_name": name, "height": h,
                           "width": w})
            for _ in range(rng.randint(objects[0], objects[1] + 1)):
                poly = random_polygon(rng, h, w)
                box = _bbox(poly)
                anns.append({"id": ann_id, "image_id": img_id,
                             "category_id": int(rng.choice(COCO_IDS)),
                             "segmentation": [poly], "bbox": box,
                             "area": box[2] * box[3], "iscrowd": 0})
                ann_id += 1
            if split == "train" and img_id == 1:
                crowd = np.zeros((h, w), np.uint8)
                crowd[h // 4:h // 2, w // 3:w // 2] = 1
                anns.append({"id": ann_id, "image_id": img_id,
                             "category_id": 1, "segmentation": rle_of(crowd),
                             "bbox": [w // 3, h // 4, w // 2 - w // 3,
                                      h // 2 - h // 4],
                             "area": int(crowd.sum()), "iscrowd": 1})
                ann_id += 1
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": CATEGORIES}, f)
    return root


def build_lvis_dir(root: str, src: Sequence[str], seed: int = 0,
                   n: int = 4) -> str:
    """LVIS v1 at ``root``: the images under ``val2017/`` and
    ``lvis_v1_val.json`` whose images name them by ``coco_url``."""
    rng = np.random.RandomState(seed)
    images, anns, ann_id = [], [], 1
    cats = [{"id": i + 1, "name": f"lvis_{i}", "frequency": "c"}
            for i in range(30)]
    for img_id, name, h, w in _copy_images(src, os.path.join(root, "val2017"),
                                           n):
        images.append({"id": img_id, "height": h, "width": w,
                       "coco_url": f"http://images.cocodataset.org/val2017/"
                                   f"{name}"})
        for _ in range(rng.randint(1, 8)):
            poly = random_polygon(rng, h, w)
            anns.append({"id": ann_id, "image_id": img_id,
                         "category_id": int(rng.randint(1, 31)),
                         "segmentation": [poly], "bbox": _bbox(poly)})
            ann_id += 1
    with open(os.path.join(root, "lvis_v1_val.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats},
                  f)
    return root


def build_panoptic_dir(root: str, src: Sequence[str], seed: int = 0,
                       n: int = 4) -> str:
    """COCO panoptic at ``root``: ``val2017/``,
    ``annotations/panoptic_val2017.json`` and the id-encoded PNGs of
    ``annotations/panoptic_val2017/`` (``write_png``), two stuff bands and
    1-5 thing polygons an image."""
    from ..alodataset.coco_panoptic import id2rgb
    from ..runtime import fill_poly
    rng = np.random.RandomState(seed)
    cats = [{"id": i, "name": n, "isthing": 1} for i, n in
            zip(COCO_IDS[:10], COCO_NAMES[:10])] + \
        [{"id": 184, "name": "sky", "isthing": 0},
         {"id": 187, "name": "road", "isthing": 0}]
    png_dir = os.path.join(root, "annotations", "panoptic_val2017")
    os.makedirs(png_dir, exist_ok=True)
    images, anns = [], []
    for img_id, name, h, w in _copy_images(src, os.path.join(root, "val2017"),
                                           n):
        ids = np.zeros((h, w), np.int64)
        segs = []
        for k, (cat, rows) in enumerate(((184, slice(0, h // 3)),
                                         (187, slice(2 * h // 3, h)))):
            seg_id = int(rng.randint(1, 1 << 24))
            ids[rows] = seg_id
            segs.append({"id": seg_id, "category_id": cat, "iscrowd": 0,
                         "bbox": [0, rows.start, w, rows.stop - rows.start]})
        for _ in range(rng.randint(1, 6)):
            poly = random_polygon(rng, h, w)
            m = fill_poly(np.zeros((h, w), np.uint8),
                          np.round(np.asarray(poly).reshape(-1, 2)))
            seg_id = int(rng.randint(1, 1 << 24))
            ids[m > 0] = seg_id
            segs.append({"id": seg_id, "iscrowd": 0, "bbox": _bbox(poly),
                         "category_id": int(rng.choice(COCO_IDS[:10]))})
        png = os.path.splitext(name)[0] + ".png"
        write_png(os.path.join(png_dir, png), id2rgb(ids))
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        anns.append({"image_id": img_id, "file_name": png,
                     "segments_info": segs})
    with open(os.path.join(root, "annotations", "panoptic_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats},
                  f)
    return root


def write_png(path: str, rgb: np.ndarray):
    """An 8-bit RGB (H, W, 3) PNG, unfiltered, deflated with zlib."""
    import struct
    import zlib

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(rgb, np.uint8))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
