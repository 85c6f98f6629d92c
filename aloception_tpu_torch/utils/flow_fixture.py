"""Seeded directories in the published layouts of the flow, KITTI and Waymo
datasets, for tests and smoke runs: Sintel, FlyingChairs2, the
FlyingThings3D subset, ChairsSDHom, KITTI (scene flow 2015, object, depth,
tracking, odometry, road, semantic) and a directory of Waymo TFRecords.

Everything is written with numpy, zlib and Pillow (no OpenCV): PNGs of 8 or
16 bits, grey or RGB (``coco_fixture.write_png``), Middlebury ``.flo``,
``.pfm``, Sintel's 8-bit disparity encoding, KITTI's label, calibration
and 16-bit flow, disparity and depth PNGs, and Waymo frames through the
converter's protobuf writers with JPEG bytes from Pillow. Images are
uniform noise; flows are smooth (an affine field plus a low sine),
occlusions are discs. Each ``build_*`` function takes its sizes (default:
the dataset's published image size) and returns ``root``.
"""

from __future__ import annotations

import io
import os
from typing import Sequence, Tuple

import numpy as np

from ..aloscene.io.flow import save_flow_flo
from .coco_fixture import write_png

SINTEL_HW = (436, 1024)
CHAIRS_HW = (384, 512)
THINGS_HW = (540, 960)
KITTI_HW = (375, 1242)
WAYMO_HW = (1280, 1920)

# KITTI's published rectified projections of the colour cameras
# (calib_cam_to_cam.txt of the 2011_09_26 drives, as the scene flow 2015
# benchmark ships them) and the object benchmark's P0-P3
P_RECT = {
    0: (7.215377e+02, 0.0, 6.095593e+02, 0.0, 0.0, 7.215377e+02, 1.728540e+02,
        0.0, 0.0, 0.0, 1.0, 0.0),
    1: (7.215377e+02, 0.0, 6.095593e+02, -3.875744e+02, 0.0, 7.215377e+02,
        1.728540e+02, 0.0, 0.0, 0.0, 1.0, 0.0),
    2: (7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01, 0.0, 7.215377e+02,
        1.728540e+02, 2.163791e-01, 0.0, 0.0, 1.0, 2.745884e-03),
    3: (7.215377e+02, 0.0, 6.095593e+02, -3.395242e+02, 0.0, 7.215377e+02,
        1.728540e+02, 2.199936e+00, 0.0, 0.0, 1.0, 2.729905e-03)}
KITTI_CLASSES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting",
                 "Cyclist", "Tram", "Misc")
# KITTI object sizes (h, w, l) in metres, about the classes' means
KITTI_SIZES = {"Car": (1.53, 1.63, 3.88), "Van": (2.21, 1.90, 5.08),
               "Truck": (3.25, 2.59, 10.1), "Pedestrian": (1.76, 0.66, 0.84),
               "Person_sitting": (1.27, 0.59, 0.80),
               "Cyclist": (1.74, 0.60, 1.76), "Tram": (3.53, 2.54, 16.1),
               "Misc": (1.91, 1.51, 3.58)}


# ---------------------------------------------------------------- writers
def write_pfm(path: str, arr: np.ndarray):
    """A (1, H, W) ("Pf") or (3, H, W) ("PF") float32 PFM, little-endian,
    rows stored bottom to top."""
    c, h, w = arr.shape
    if c not in (1, 3):
        raise ValueError(f"a PFM holds 1 or 3 channels, got {c}")
    data = np.flipud(np.moveaxis(arr, 0, -1)).astype("<f4")
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        f.write(data.tobytes())


def sintel_disparity_rgb(disp: np.ndarray) -> np.ndarray:
    """(H, W) disparity -> the (H, W, 3) uint8 RGB of Sintel's encoding,
    whose R * 4 + G / 64 + B / 16384 gives it back to 1/16384."""
    disp = np.asarray(disp, np.float64)
    r = np.floor(disp / 4.0)
    g = np.floor(disp * 2.0 ** 6) % 256
    b = np.floor(disp * 2.0 ** 14) % 256
    return np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8)


def kitti_flow_png(flow: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(2, H, W) flow and (H, W) valid -> KITTI's (H, W, 3) uint16 RGB:
    flow * 64 + 2^15 rounded, and 1 where valid."""
    uv = np.rint(np.moveaxis(flow, 0, -1) * 64.0 + 2 ** 15)
    out = np.concatenate([uv.clip(0, 65535), valid[..., None]], -1)
    return out.astype(np.uint16)


def kitti_16bit_png(value: np.ndarray) -> np.ndarray:
    """(H, W) disparity or depth (0 where missing) -> value * 256 as
    uint16, KITTI's encoding."""
    return np.rint(np.asarray(value, np.float64) * 256).clip(
        0, 65535).astype(np.uint16)


def jpeg_bytes(rgb: np.ndarray, quality: int = 90) -> bytes:
    """A baseline 4:2:0 JPEG of an (H, W, 3) uint8 image, by Pillow."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


# ---------------------------------------------------------------- content
def noise_image(rng: np.random.RandomState, hw: Tuple[int, int]
                ) -> np.ndarray:
    return rng.randint(0, 256, hw + (3,), dtype=np.uint8)


def smooth_flow(rng: np.random.RandomState, hw: Tuple[int, int],
                amplitude: float = 8.0) -> np.ndarray:
    """(2, H, W) float32: an affine field plus a low sine, up to about
    ``amplitude`` pixels."""
    h, w = hw
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    out = []
    for _ in range(2):
        a = rng.uniform(-1, 1, 4)
        phase = rng.uniform(0, 2 * np.pi)
        out.append(amplitude * (0.4 * a[0] + 0.3 * a[1] * xs + 0.3 * a[2] * ys
                                + 0.2 * np.sin(np.pi * (xs + a[3] * ys)
                                               + phase)))
    return np.stack(out).astype(np.float32)


def disc_mask(rng: np.random.RandomState, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) bool: one or two discs of 5-15 % of the shorter side."""
    h, w = hw
    ys, xs = np.mgrid[:h, :w]
    m = np.zeros(hw, bool)
    for _ in range(rng.randint(1, 3)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.15) * min(h, w) + 1
        m |= (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
    return m


def grey_mask_png(path: str, mask: np.ndarray):
    write_png(path, (mask * 255).astype(np.uint8), level=1)


def _mkdirs(*paths: str):
    for p in paths:
        os.makedirs(p, exist_ok=True)


# -------------------------------------------------------- flow datasets
def build_sintel_dir(root: str, seed: int = 0, scenes: int = 2,
                     frames: int = 6, hw: Tuple[int, int] = SINTEL_HW,
                     passes: Sequence[str] = ("clean",),
                     disparities: bool = True) -> str:
    """Sintel's ``training/``: ``<pass>/<scene>/frame_%04d.png`` from 1,
    ``flow/<scene>/frame_%04d.flo`` of every frame but the last,
    ``occlusions/`` grey PNGs, and ``disparities/`` in Sintel's encoding."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    for s in range(scenes):
        scene = f"scene_{s}"
        dirs = {k: os.path.join(base, k, scene) for k in
                (*passes, "flow", "occlusions", "disparities")}
        _mkdirs(*dirs.values())
        for i in range(1, frames + 1):
            name = f"frame_{i:04d}"
            for p in passes:
                write_png(os.path.join(dirs[p], name + ".png"),
                          noise_image(rng, hw), level=1)
            grey_mask_png(os.path.join(dirs["occlusions"], name + ".png"),
                          disc_mask(rng, hw))
            if i < frames:
                save_flow_flo(os.path.join(dirs["flow"], name + ".flo"),
                              smooth_flow(rng, hw))
            if disparities:
                disp = np.abs(smooth_flow(rng, hw, 30.0)[0]) + 1
                write_png(os.path.join(dirs["disparities"], name + ".png"),
                          sintel_disparity_rgb(disp), level=1)
    return root


def build_chairs2_dir(root: str, seed: int = 0, n_train: int = 4,
                      n_val: int = 2, hw: Tuple[int, int] = CHAIRS_HW) -> str:
    """FlyingChairs2's ``train/`` and ``val/``: ``%07d-img_0.png``,
    ``-img_1.png``, ``-flow_01.flo`` and ``-occ_01.png``, and a
    ``-flow_10.flo`` beside the first pair of each split (the backward
    flow, which the dataset does not index)."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, split)
        _mkdirs(d)
        for k in range(n):
            stem = os.path.join(d, f"{k:07d}")
            write_png(stem + "-img_0.png", noise_image(rng, hw), level=1)
            write_png(stem + "-img_1.png", noise_image(rng, hw), level=1)
            save_flow_flo(stem + "-flow_01.flo", smooth_flow(rng, hw))
            grey_mask_png(stem + "-occ_01.png", disc_mask(rng, hw))
            if k == 0:
                save_flow_flo(stem + "-flow_10.flo", smooth_flow(rng, hw))
    return root


def build_things_dir(root: str, seed: int = 0,
                     ids: Sequence[int] = (0, 1, 2, 4, 5),
                     hw: Tuple[int, int] = THINGS_HW,
                     splits: Sequence[str] = ("train", "val")) -> str:
    """The FlyingThings3D subset's ``<split>/``:
    ``image_clean/left/%07d.png`` (the ids, a gap between non-consecutive
    ones), ``flow/left/into_future/%07d.flo`` with
    ``flow_occlusions/left/into_future/%07d.png``, and positive
    ``disparity/left/%07d.pfm``."""
    rng = np.random.RandomState(seed)
    for split in splits:
        base = os.path.join(root, split)
        img = os.path.join(base, "image_clean", "left")
        flow = os.path.join(base, "flow", "left", "into_future")
        occ = os.path.join(base, "flow_occlusions", "left", "into_future")
        disp = os.path.join(base, "disparity", "left")
        _mkdirs(img, flow, occ, disp)
        for i in ids:
            write_png(os.path.join(img, f"{i:07d}.png"), noise_image(rng, hw),
                      level=1)
            save_flow_flo(os.path.join(flow, f"{i:07d}.flo"),
                          smooth_flow(rng, hw))
            grey_mask_png(os.path.join(occ, f"{i:07d}.png"),
                          disc_mask(rng, hw))
            write_pfm(os.path.join(disp, f"{i:07d}.pfm"),
                      np.abs(smooth_flow(rng, hw, 40.0)[:1]) + 0.5)
    return root


def build_sdhom_dir(root: str, seed: int = 0, n_train: int = 3,
                    n_val: int = 2, hw: Tuple[int, int] = CHAIRS_HW) -> str:
    """ChairsSDHom's ``data/train/`` and ``data/test/``: ``t0/%05d.png``,
    ``t1/%05d.png`` and ``flow/%05d.pfm`` (3 channels, the third 0), the
    first of each split as ``.flo`` instead."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("test", n_val)):
        base = os.path.join(root, "data", split)
        _mkdirs(*(os.path.join(base, k) for k in ("t0", "t1", "flow")))
        for k in range(n):
            stem = f"{k:05d}"
            for t in ("t0", "t1"):
                write_png(os.path.join(base, t, stem + ".png"),
                          noise_image(rng, hw), level=1)
            flow = smooth_flow(rng, hw, 3.0)
            if k == 0:
                save_flow_flo(os.path.join(base, "flow", stem + ".flo"), flow)
            else:
                write_pfm(os.path.join(base, "flow", stem + ".pfm"),
                          np.concatenate([flow, np.zeros_like(flow[:1])]))
    return root


# ----------------------------------------------------------------- KITTI
def calib_cam_to_cam_text(cams: Sequence[int] = (0, 1, 2, 3)) -> str:
    """A calib_cam_to_cam.txt with its time stamp line (which parses to no
    number), the per-camera S/K/D/R/T rows and ``P_rect_0X`` of ``cams``."""
    lines = ["calib_time: 09-Jan-2012 13:57:47", "corner_dist: 9.950000e-02"]
    for c in (0, 1, 2, 3):
        lines += [f"S_0{c}: 1.392000e+03 5.120000e+02",
                  f"K_0{c}: 9.842439e+02 0.000000e+00 6.900000e+02 "
                  "0.000000e+00 9.808141e+02 2.331966e+02 0.000000e+00 "
                  "0.000000e+00 1.000000e+00",
                  f"D_0{c}: -3.728755e-01 2.037299e-01 2.219027e-03 "
                  "1.383707e-03 -7.233722e-02",
                  f"R_0{c}: 1 0 0 0 1 0 0 0 1",
                  f"T_0{c}: 0 0 0",
                  f"S_rect_0{c}: 1.242000e+03 3.750000e+02",
                  f"R_rect_0{c}: 1 0 0 0 1 0 0 0 1"]
        if c in cams:
            lines.append(f"P_rect_0{c}: "
                         + " ".join(f"{v:e}" for v in P_RECT[c]))
    return "\n".join(lines) + "\n"


def object_calib_text() -> str:
    """The object benchmark's calib/<id>.txt: P0-P3, R0_rect and the lidar
    and IMU transforms."""
    lines = [f"P{c}: " + " ".join(f"{v:.12e}" for v in P_RECT[c])
             for c in range(4)]
    lines += ["R0_rect: " + " ".join(f"{v:.12e}" for v in np.eye(3).ravel()),
              "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 "
              "-4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 "
              "-7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 "
              "-2.717806e-01",
              "Tr_imu_to_velo: 9.999976e-01 7.553071e-04 -2.035826e-03 "
              "-8.086759e-01 -7.854027e-04 9.998898e-01 -1.482298e-02 "
              "3.195559e-01 2.024406e-03 1.482454e-02 9.998881e-01 "
              "-7.997231e-01"]
    return "\n".join(lines) + "\n"


def kitti_label_lines(rng: np.random.RandomState, n: int,
                      hw: Tuple[int, int] = KITTI_HW,
                      dont_care: int = 2) -> str:
    """``n`` label_2 lines of the 8 classes (type, truncated, occluded,
    alpha, the 2-D box x1 y1 x2 y2, h w l, the bottom centre x y z in the
    camera frame, rotation_y) and ``dont_care`` DontCare lines, in KITTI's
    number formats; the 2-D box encloses the 3-D box's projection, clipped
    to the image."""
    h_img, w_img = hw
    P = np.asarray(P_RECT[2]).reshape(3, 4)
    lines = []
    for _ in range(n):
        cls = KITTI_CLASSES[rng.randint(len(KITTI_CLASSES))]
        h, w, l = (s * rng.uniform(0.9, 1.1) for s in KITTI_SIZES[cls])
        z = rng.uniform(5, 60)
        x, y = rng.uniform(-0.4, 0.4) * z, 1.65 + rng.uniform(-0.2, 0.2)
        ry = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(ry), np.sin(ry)
        dx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
        dz = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
        dy = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h
        pts = np.stack([x + c * dx + s * dz, y + dy, z - s * dx + c * dz,
                        np.ones(8)])
        uvw = P @ pts
        u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
        x1, x2 = np.clip([u.min(), u.max()], 0, w_img - 1)
        y1, y2 = np.clip([v.min(), v.max()], 0, h_img - 1)
        alpha = ry - np.arctan2(x, z)
        lines.append(f"{cls} {rng.choice([0.0, 0.12, 0.5]):.2f} "
                     f"{rng.randint(0, 4)} {alpha:.2f} {x1:.2f} {y1:.2f} "
                     f"{x2:.2f} {y2:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} "
                     f"{y:.2f} {z:.2f} {ry:.2f}")
    for _ in range(dont_care):
        x1, y1 = rng.uniform(0, w_img - 40), rng.uniform(0, h_img - 20)
        lines.append(f"DontCare -1 -1 -10 {x1:.2f} {y1:.2f} {x1 + 30:.2f} "
                     f"{y1 + 15:.2f} -1 -1 -1 -1000 -1000 -1000 -10")
    return "\n".join(lines) + "\n"


def build_kitti_sflow_dir(root: str, seed: int = 0, n: int = 3,
                          hw: Tuple[int, int] = KITTI_HW,
                          gaps: bool = True) -> str:
    """Scene flow 2015's ``training/``: ``image_2`` and ``image_3`` at
    ``%06d_10.png`` and ``_11.png``; the 16-bit PNGs of ``%06d_10``:
    ``disp_noc_0``/``disp_occ_0`` (the first pair's disparity),
    ``disp_noc_1``/``disp_occ_1`` (the second pair's) and
    ``flow_noc``/``flow_occ``, sparse (about a third of the pixels
    invalid); ``calib_cam_to_cam/%06d.txt``. With ``gaps`` and ``n`` > 1
    the last id has no ``image_3`` and a calibration without ``P_rect_03``
    (no baseline)."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    dirs = ("image_2", "image_3", "disp_noc_0", "disp_occ_0", "disp_noc_1",
            "disp_occ_1", "flow_noc", "flow_occ", "calib_cam_to_cam")
    _mkdirs(*(os.path.join(base, d) for d in dirs))
    for k in range(n):
        partial = gaps and n > 1 and k == n - 1
        for cam in ("image_2",) if partial else ("image_2", "image_3"):
            for t in (10, 11):
                write_png(os.path.join(base, cam, f"{k:06d}_{t}.png"),
                          noise_image(rng, hw), level=1)
        occ_valid = rng.uniform(size=hw) > 0.3
        noc_valid = occ_valid & ~disc_mask(rng, hw)
        disp = np.abs(smooth_flow(rng, hw, 60.0)) + 1
        flow = smooth_flow(rng, hw, 20.0)
        for name, valid in (("occ", occ_valid), ("noc", noc_valid)):
            for t in (0, 1):
                write_png(os.path.join(base, f"disp_{name}_{t}",
                                       f"{k:06d}_10.png"),
                          kitti_16bit_png(np.where(valid, disp[t], 0)),
                          level=1)
            write_png(os.path.join(base, f"flow_{name}", f"{k:06d}_10.png"),
                      kitti_flow_png(flow * valid, valid), level=1)
        with open(os.path.join(base, "calib_cam_to_cam", f"{k:06d}.txt"),
                  "w") as f:
            f.write(calib_cam_to_cam_text((0, 1, 2) if partial
                                          else (0, 1, 2, 3)))
    return root


def build_kitti_object_dir(root: str, seed: int = 0, n: int = 3,
                           hw: Tuple[int, int] = KITTI_HW, boxes: int = 30,
                           gaps: bool = True) -> str:
    """The object benchmark's ``training/``: ``image_2/%06d.png``,
    ``label_2/%06d.txt`` (``boxes`` objects and 2 DontCare) and
    ``calib/%06d.txt``; with ``gaps`` the second frame has no
    calibration."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    _mkdirs(*(os.path.join(base, d) for d in ("image_2", "label_2", "calib")))
    for k in range(n):
        write_png(os.path.join(base, "image_2", f"{k:06d}.png"),
                  noise_image(rng, hw), level=1)
        with open(os.path.join(base, "label_2", f"{k:06d}.txt"), "w") as f:
            f.write(kitti_label_lines(rng, boxes, hw))
        if not (gaps and k == 1):
            with open(os.path.join(base, "calib", f"{k:06d}.txt"), "w") as f:
                f.write(object_calib_text())
    return root


def build_kitti_depth_dir(root: str, seed: int = 0,
                          subsets: Sequence[str] = ("val",), drives: int = 2,
                          frames: int = 2,
                          hw: Tuple[int, int] = KITTI_HW,
                          gaps: bool = True) -> str:
    """KITTI depth: ``<subset>/<drive>/proj_depth/groundtruth/image_02/
    %010d.png`` (16-bit, about 80 % of the pixels without a lidar return)
    and the frames ``<subset>/<drive>/image_02/data/%010d.png``; with
    ``gaps`` the last frame of the last drive has no RGB file."""
    rng = np.random.RandomState(seed)
    for subset in subsets:
        for d in range(drives):
            drive = os.path.join(root, subset,
                                 f"2011_09_26_drive_{d + 1:04d}_sync")
            gt = os.path.join(drive, "proj_depth", "groundtruth", "image_02")
            rgb = os.path.join(drive, "image_02", "data")
            _mkdirs(gt, rgb)
            for i in range(frames):
                depth = 2 + np.abs(smooth_flow(rng, hw, 60.0)[0])
                depth[rng.uniform(size=hw) < 0.8] = 0
                write_png(os.path.join(gt, f"{i + 5:010d}.png"),
                          kitti_16bit_png(depth), level=1)
                if not (gaps and d == drives - 1 and i == frames - 1):
                    write_png(os.path.join(rgb, f"{i + 5:010d}.png"),
                              noise_image(rng, hw), level=1)
    return root


def build_kitti_tracking_dir(root: str, seed: int = 0,
                             sequences: Sequence[int] = (0, 1, 3),
                             frames: int = 3,
                             hw: Tuple[int, int] = KITTI_HW) -> str:
    """Tracking's ``training/image_02/%04d/%06d.png``."""
    rng = np.random.RandomState(seed)
    for s in sequences:
        d = os.path.join(root, "training", "image_02", f"{s:04d}")
        _mkdirs(d)
        for i in range(frames):
            write_png(os.path.join(d, f"{i:06d}.png"), noise_image(rng, hw),
                      level=1)
    return root


def build_kitti_odometry_dir(root: str, seed: int = 0,
                             sequences: Sequence[int] = (0, 2),
                             frames: int = 3,
                             hw: Tuple[int, int] = KITTI_HW) -> str:
    """Odometry's ``sequences/%02d/image_2/%06d.png`` and
    ``poses/%02d.txt`` (12 numbers a line: the 3x4 pose of each frame) for
    all sequences but the last."""
    rng = np.random.RandomState(seed)
    _mkdirs(os.path.join(root, "poses"))
    for j, s in enumerate(sequences):
        d = os.path.join(root, "sequences", f"{s:02d}", "image_2")
        _mkdirs(d)
        poses = []
        for i in range(frames):
            write_png(os.path.join(d, f"{i:06d}.png"), noise_image(rng, hw),
                      level=1)
            a = rng.uniform(-0.1, 0.1)
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]])
            poses.append(np.concatenate([R, rng.uniform(-5, 5, (3, 1))], 1))
        if j < len(sequences) - 1:
            np.savetxt(os.path.join(root, "poses", f"{s:02d}.txt"),
                       np.stack(poses).reshape(frames, 12), fmt="%e")
    return root


def build_kitti_road_dir(root: str, seed: int = 0, n: int = 3,
                         hw: Tuple[int, int] = KITTI_HW) -> str:
    """Road's ``training/image_2/<cat>_%06d.png`` (categories um, umm, uu)
    and ``gt_image_2/<cat>_road_%06d.png`` in its colours: road magenta,
    other red, unlabelled black; the last frame has no ground truth."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    _mkdirs(os.path.join(base, "image_2"), os.path.join(base, "gt_image_2"))
    for k in range(n):
        cat = ("um", "umm", "uu")[k % 3]
        write_png(os.path.join(base, "image_2", f"{cat}_{k:06d}.png"),
                  noise_image(rng, hw), level=1)
        if k == n - 1:
            continue
        gt = np.zeros(hw + (3,), np.uint8)
        gt[hw[0] // 3:, :, 0] = 255
        road = disc_mask(rng, hw)
        gt[road] = (255, 0, 255)
        gt[: hw[0] // 4] = 0
        write_png(os.path.join(base, "gt_image_2", f"{cat}_road_{k:06d}.png"),
                  gt, level=1)
    return root


def build_kitti_semantic_dir(root: str, seed: int = 0, n: int = 2,
                             hw: Tuple[int, int] = KITTI_HW) -> str:
    """Semantic's ``training/image_2/%06d_10.png`` and
    ``training/semantic/%06d_10.png``: ids 0-33 in bands, as a grey PNG, and
    for odd frames as an RGB PNG with the id in each channel but noise on
    one (read as grey through the PNG colour conversion)."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    _mkdirs(os.path.join(base, "image_2"), os.path.join(base, "semantic"))
    for k in range(n):
        write_png(os.path.join(base, "image_2", f"{k:06d}_10.png"),
                  noise_image(rng, hw), level=1)
        ids = rng.choice(34, 6, replace=False)
        sem = ids[np.minimum(np.arange(hw[0]) * 6 // hw[0], 5)][:, None] \
            .repeat(hw[1], 1).astype(np.uint8)
        if k % 2:
            sem = np.stack([sem, sem, sem], -1)
            sem[..., 2] = rng.randint(0, 40, hw)
        write_png(os.path.join(base, "semantic", f"{k:06d}_10.png"), sem,
                  level=1)
    return root


# ----------------------------------------------------------------- Waymo
# the front camera of a Waymo segment: f_u f_v c_u c_v k1 k2 p1 p2 k3, and
# its camera -> vehicle transform (Waymo axes: X forward, Y left, Z up)
WAYMO_INTRINSIC = (2055.556, 2055.556, 939.658, 641.072, 0.0323, -0.3214,
                   0.0006, -0.0005, 0.0)


def waymo_extrinsic(yaw: float = 0.004, pitch: float = -0.006
                    ) -> np.ndarray:
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    R = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array(
        [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    E = np.eye(4)
    E[:3, :3], E[:3, 3] = R, (1.54, -0.02, 2.12)
    return E


def waymo_frame_record(rng: np.random.RandomState, idx: int, segment: str,
                       hw: Tuple[int, int] = WAYMO_HW, boxes: int = 30,
                       cameras: Sequence[int] = (1,)) -> bytes:
    """One serialized Waymo ``Frame``: its context (name, each camera's
    calibration), timestamp, pose, a JPEG of each camera, ``boxes`` laser
    labels (3-D boxes ahead of the vehicle; one in ten a sign, which the
    converter drops) and the front camera's 2-D labels."""
    from ..alodataset.prepare import waymo_converter as wc

    def box(cx, cy, cz, ln, wd, ht, heading):
        return b"".join(wc.field_double(k + 1, float(v)) for k, v in
                        enumerate((cx, cy, cz, ln, wd, ht, heading)))

    def label(b, typ, lid):
        return (wc.field_bytes(1, b) + wc.field_varint(3, typ)
                + wc.field_bytes(4, lid.encode()))
    h, w = hw
    ctx = wc.field_bytes(1, segment.encode())
    for cam in cameras:
        calib = (wc.field_varint(1, cam)
                 + wc.packed_doubles(2, list(WAYMO_INTRINSIC))
                 + wc.field_bytes(3, wc.packed_doubles(
                     1, list(waymo_extrinsic(0.3 * (cam - 1)).ravel())))
                 + wc.field_varint(4, w) + wc.field_varint(5, h))
        ctx += wc.field_bytes(2, calib)
    pose = np.eye(4)
    pose[:3, 3] = (10.0 * idx, 0.1 * idx, 0.0)
    out = (wc.field_bytes(1, ctx) + wc.field_varint(2, 1550083467346370 +
                                                    100000 * idx)
           + wc.field_bytes(3, wc.packed_doubles(1, list(pose.ravel()))))
    for cam in cameras:
        out += wc.field_bytes(4, wc.field_varint(1, cam) + wc.field_bytes(
            2, jpeg_bytes(noise_image(rng, hw))))
    for j in range(boxes):
        typ = 3 if j % 10 == 9 else int(rng.choice([1, 1, 1, 2, 4]))
        size = {1: (4.5, 2.0, 1.7), 2: (0.9, 0.9, 1.8), 3: (0.2, 0.8, 0.8),
                4: (1.8, 0.8, 1.7)}[typ]
        b = box(rng.uniform(5, 70), rng.uniform(-15, 15),
                rng.uniform(0.5, 1.5), *(s * rng.uniform(0.9, 1.1)
                                         for s in size),
                rng.uniform(-np.pi, np.pi))
        out += wc.field_bytes(6, label(b, typ, f"obj-{j}"))
    cam_labels = wc.field_varint(1, cameras[0])
    for j in range(boxes):
        typ = 3 if j % 10 == 9 else int(rng.choice([1, 2, 4]))
        b = box(rng.uniform(0, w), rng.uniform(0, h), 0,
                rng.uniform(20, 400), rng.uniform(20, 300), 0, 0)
        cam_labels += wc.field_bytes(2, label(b, typ, f"cam-{j}"))
    return out + wc.field_bytes(8, cam_labels)


def build_waymo_tfrecord_dir(root: str, seed: int = 0, frames: int = 10,
                             hw: Tuple[int, int] = WAYMO_HW, boxes: int = 30,
                             cameras: Sequence[int] = (1,),
                             segments: int = 1) -> str:
    """``segments`` TFRecords of ``frames`` Waymo frames each, named as the
    published ``segment-<id>_with_camera_labels.tfrecord`` files."""
    from ..alodataset.prepare.waymo_converter import write_tfrecord
    rng = np.random.RandomState(seed)
    _mkdirs(root)
    for s in range(segments):
        name = f"segment-{10017090168044687777 + s}_6380_000_6400_000"
        write_tfrecord(
            os.path.join(root, f"{name}_with_camera_labels.tfrecord"),
            [waymo_frame_record(rng, i, name, hw, boxes, cameras)
             for i in range(frames)])
    return root
