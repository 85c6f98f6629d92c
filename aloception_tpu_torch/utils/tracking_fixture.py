"""Seeded directories in the published layouts of the tracking and crowd
datasets, for tests and smoke runs: MOT17, CrowdHuman and WoodScape.

Everything is written with numpy, zlib and Pillow (no OpenCV): JPEGs by
Pillow, PNGs by ``coco_fixture.write_png``, the text annotations by hand.
Images are smooth colour fields with mild noise (they compress as photos
do, so a 1080p or 4K frame stays a few hundred KB); each ``build_*``
function takes its sizes (default: the dataset's published image size) and
returns ``root``.

- MOT17: ``<split>/MOT17-XX-<detector>/{seqinfo.ini, img1/%06d.jpg,
  gt/gt.txt}``, gt rows of frame, track, x, y, w, h, conf, class,
  visibility (some with conf 0, visibilities spread over [0, 1]).
- CrowdHuman: ``CrowdHuman_<split>/Images/<ID>.jpg`` and
  ``annotation_<split>.odgt``: records of 1..12 boxes (one record of a
  single box, which the datasets drop), "mask" regions, ignored boxes and a
  degenerate box among them, each with fbox, vbox and hbox.
- WoodScape: ``rgb_images/<n>_<camera>.png``, ``box_2d_annotations/<n>_
  <camera>.txt`` (class, class id, x1, y1, x2, y2; comma separated, or
  space separated for odd n; a class outside the five among them) and
  ``semantic_annotations/gtLabels/<n>_<camera>.png`` (class indices 0..9).
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from .coco_fixture import write_png
from .flow_fixture import jpeg_bytes

MOT17_HW = (1080, 1920)          # MOT17-02's frames
WOODSCAPE_HW = (966, 1280)
WOODSCAPE_CAMERAS = ("FV", "RV", "MVL", "MVR")
WOODSCAPE_BOX_CLASSES = ("vehicles", "person", "bicycle", "traffic_light",
                         "traffic_sign", "rider")


def scene_image(rng: np.random.RandomState, hw: Tuple[int, int]
                ) -> np.ndarray:
    """(H, W, 3) uint8: three low-frequency colour waves plus noise of +-8."""
    h, w = hw
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xs = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    out = np.empty((h, w, 3), np.uint8)
    for c in range(3):
        a, b, p = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6.3)
        field = 128 + 80 * np.sin(a * 6.28 * xs + b * 3.14 * ys + p)
        noise = rng.randint(-8, 9, (h, w)).astype(np.float32)
        out[..., c] = np.clip(field + noise, 0, 255).astype(np.uint8)
    return out


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90):
    with open(path, "wb") as f:
        f.write(jpeg_bytes(rgb, quality))


def _box(rng, hw, min_side=8):
    """An [x, y, w, h] box of integer pixels, mostly inside the image."""
    h, w = hw
    bw = int(rng.uniform(min_side, max(min_side + 1, w / 4)))
    bh = int(rng.uniform(min_side, max(min_side + 1, h / 3)))
    return [int(rng.randint(-bw // 4, w - bw // 2)),
            int(rng.randint(-bh // 4, h - bh // 2)), bw, bh]


# ------------------------------------------------------------------ MOT17
def build_mot17_dir(root: str, seed: int = 0,
                    sequences: Sequence[str] = ("MOT17-02-FRCNN",
                                                "MOT17-02-DPM",
                                                "MOT17-04-FRCNN"),
                    frames: int = 8, hw: Tuple[int, int] = MOT17_HW,
                    tracks: int = 6, split: str = "train") -> str:
    rng = np.random.RandomState(seed)
    for seq in sequences:
        d = os.path.join(root, split, seq)
        os.makedirs(os.path.join(d, "img1"), exist_ok=True)
        os.makedirs(os.path.join(d, "gt"), exist_ok=True)
        with open(os.path.join(d, "seqinfo.ini"), "w") as f:
            f.write(f"[Sequence]\nname={seq}\nimDir=img1\nframeRate=30\n"
                    f"seqLength={frames}\nimWidth={hw[1]}\n"
                    f"imHeight={hw[0]}\nimExt=.jpg\n")
        starts = [_box(rng, hw, 16) for _ in range(tracks)]
        speed = rng.uniform(-6, 6, (tracks, 2))
        rows = []
        for t in range(1, frames + 1):
            write_jpeg(os.path.join(d, "img1", f"{t:06d}.jpg"),
                       scene_image(rng, hw))
            for k, (x, y, w, h) in enumerate(starts):
                if rng.uniform() < 0.15:
                    continue              # the track is not in this frame
                conf = 0 if rng.uniform() < 0.1 else 1
                vis = round(float(rng.uniform(0, 1)), 5)
                rows.append(f"{t},{k + 1},{x + speed[k, 0] * t:.1f},"
                            f"{y + speed[k, 1] * t:.1f},{w},{h},{conf},1,"
                            f"{vis}")
        with open(os.path.join(d, "gt", "gt.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root


# ------------------------------------------------------------- CrowdHuman
def crowd_human_record(rng: np.random.RandomState, image_id: str,
                       hw: Tuple[int, int], n: int) -> dict:
    boxes = []
    for k in range(n):
        fbox = _box(rng, hw)
        x, y, w, h = fbox
        vbox = [x + w // 8, y + h // 8, max(1, 3 * w // 4), max(1, 3 * h // 4)]
        hbox = [x + w // 3, y, max(1, w // 3), max(1, h // 6)]
        tag = "mask" if k == 1 and n > 3 else "person"
        ignore = 1 if k == 2 and n > 4 else 0
        if k == 3 and n > 5:
            fbox = [x, y, 0, h]           # degenerate
        boxes.append({"tag": tag, "hbox": hbox, "fbox": fbox, "vbox": vbox,
                      "extra": {"box_id": k, "occ": 0, "ignore": ignore},
                      "head_attr": {"ignore": 0, "occ": 0, "unsure": 0}})
    return {"ID": image_id, "gtboxes": boxes}


def build_crowd_human_dir(root: str, seed: int = 0,
                          sizes: Sequence[Tuple[int, int]] = (
                              (1600, 2400), (720, 1280), (2400, 1600),
                              (600, 900)),
                          val_sizes: Sequence[Tuple[int, int]] = None,
                          splits: Sequence[str] = ("train", "val"),
                          test_images: int = 0, single_last: bool = True
                          ) -> str:
    """``sizes`` are the (H, W) of the train split's images in turn,
    ``val_sizes`` the val split's (default: ``sizes``); with
    ``single_last`` the record of the last image of each split has a single
    box (the datasets drop it)."""
    rng = np.random.RandomState(seed)
    for split in splits:
        img_dir = os.path.join(root, f"CrowdHuman_{split}", "Images")
        os.makedirs(img_dir, exist_ok=True)
        lines = []
        split_sizes = val_sizes if split == "val" and val_sizes else sizes
        for i, hw in enumerate(split_sizes):
            image_id = f"{273271 + i},{rng.randint(1 << 30):08x}{split[0]}"
            write_jpeg(os.path.join(img_dir, image_id + ".jpg"),
                       scene_image(rng, hw))
            n = int(rng.randint(2, 13))
            if single_last and i == len(split_sizes) - 1:
                n = 1
            lines.append(json.dumps(crowd_human_record(rng, image_id, hw, n)))
        with open(os.path.join(root, f"annotation_{split}.odgt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    if test_images:
        d = os.path.join(root, "CrowdHuman_test", "images_test")
        os.makedirs(d, exist_ok=True)
        for i in range(test_images):
            write_jpeg(os.path.join(d, f"test_{i:04d}.jpg"),
                       scene_image(rng, (240, 320)))
    return root


# -------------------------------------------------------------- WoodScape
def build_woodscape_dir(root: str, seed: int = 0, n: int = 1,
                        cameras: Sequence[str] = WOODSCAPE_CAMERAS,
                        hw: Tuple[int, int] = WOODSCAPE_HW,
                        boxes: int = 6) -> str:
    """``n`` frames for each of ``cameras``."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "rgb_images")
    box_dir = os.path.join(root, "box_2d_annotations")
    seg_dir = os.path.join(root, "semantic_annotations", "gtLabels")
    for d in (img_dir, box_dir, seg_dir):
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        for cam in cameras:
            stem = f"{i:05d}_{cam}"
            write_png(os.path.join(img_dir, stem + ".png"),
                      scene_image(rng, hw), level=1)
            sep = " " if i % 2 else ","
            rows = []
            for _ in range(boxes):
                cls = int(rng.randint(len(WOODSCAPE_BOX_CLASSES)))
                x, y, w, h = _box(rng, hw)
                rows.append(sep.join([WOODSCAPE_BOX_CLASSES[cls], str(cls),
                                      str(x), str(y), str(x + w),
                                      str(y + h)]))
            with open(os.path.join(box_dir, stem + ".txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
            # class-index blocks of 1/8 of the image, as a coarse scene
            bh, bw = -(-hw[0] // 8), -(-hw[1] // 8)
            blocks = rng.randint(0, 10, (8, 8)).astype(np.uint8)
            sem = np.kron(blocks, np.ones((bh, bw), np.uint8))[:hw[0], :hw[1]]
            write_png(os.path.join(seg_dir, stem + ".png"),
                      np.ascontiguousarray(sem), level=1)
    return root
