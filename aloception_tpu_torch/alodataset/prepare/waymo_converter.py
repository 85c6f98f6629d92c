"""Waymo Open Dataset TFRecord -> the prepared on-disk layout
(counterpart of ``aloception_tpu/alodataset/prepare/waymo_converter.py``,
the port's own copy). Pure Python with ``struct``: the TFRecord framing and
the protobuf wire format are parsed directly, so neither TensorFlow nor the
waymo-open-dataset package is needed.

Output layout (what ``WaymoDataset`` reads, waymo.py):

    <out_dir>/<segment>/<camera>/{%06d.jpg, %06d.json}

with the json carrying boxes2d (xcyc absolute), classes2d, boxes3d
([xc, yc, zc, Dx, Dy, Dz, heading], vehicle frame), classes3d, the 3x4
camera intrinsic, and the frame pose.

Field numbers follow the public waymo_open_dataset/dataset.proto and
label.proto schemas:

    Frame:   context=1, timestamp_micros=2, pose=3, images=4,
             laser_labels=6, camera_labels=8
    Context: name=1, camera_calibrations=2
    CameraCalibration: name=1, intrinsic=2 (f_u f_v c_u c_v k1 k2 p1 p2 k3),
             extrinsic=3, width=4, height=5
    CameraImage: name=1, image=2
    CameraLabels: name=1, labels=2
    Label:   box=1, type=3, id=4
    Box:     center_x=1, center_y=2, center_z=3, length=4, width=5,
             height=6, heading=7
    Transform: transform=1 (16 doubles, row-major 4x4)

Camera name enum: FRONT=1 ... SIDE_RIGHT=5; label type enum:
VEHICLE=1, PEDESTRIAN=2, SIGN=3, CYCLIST=4.
"""

from __future__ import annotations

import json
import os
import struct
from glob import glob
from typing import Dict, Iterator, List, Tuple

CAMERA_NAMES = {1: "front", 2: "front_left", 3: "front_right",
                4: "side_left", 5: "side_right"}
# label type enum -> index into waymo.py CLASSES (vehicle, pedestrian,
# sign, cyclist)
TYPE_TO_CLASS = {1: 0, 2: 1, 3: 2, 4: 3}


# ---------------------------------------------------------------- TFRecord

def iter_tfrecord(path: str) -> Iterator[bytes]:
    """Yield raw records: [uint64 length][u32 crc][payload][u32 crc].
    CRCs are not validated (masked crc32c; corruption surfaces as a parse
    error downstream anyway)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f"truncated record in {path}")
            f.read(4)  # data crc
            yield payload


def write_tfrecord(path: str, records: List[bytes]) -> None:
    """Inverse of iter_tfrecord (zeroed CRCs), for fixtures."""
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)))
            f.write(b"\x00" * 4)
            f.write(rec)
            f.write(b"\x00" * 4)


# ------------------------------------------------------- proto wire format

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). wire types: 0 varint,
    1 fixed64, 2 length-delimited (bytes), 5 fixed32."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_doubles(v: bytes) -> List[float]:
    return list(struct.unpack(f"<{len(v) // 8}d", v))


# encoders (fixtures, and the schema's documentation)

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def packed_doubles(num: int, vals) -> bytes:
    return field_bytes(num, struct.pack(f"<{len(vals)}d", *vals))


# ------------------------------------------------------------ Frame parse

def _parse_box(buf: bytes) -> Dict[str, float]:
    box = {}
    names = {1: "cx", 2: "cy", 3: "cz", 4: "length", 5: "width",
             6: "height", 7: "heading"}
    for f, wt, v in iter_fields(buf):
        if f in names:
            box[names[f]] = float(v)
    return box


def _parse_label(buf: bytes) -> Dict:
    out = {"box": {}, "type": 0, "id": ""}
    for f, wt, v in iter_fields(buf):
        if f == 1:
            out["box"] = _parse_box(v)
        elif f == 3:
            out["type"] = int(v)
        elif f == 4:
            out["id"] = v.decode("utf-8", "replace")
    return out


def parse_frame(buf: bytes) -> Dict:
    """Parse the subset of a waymo Frame proto the prepared layout needs."""
    frame = {"images": {}, "camera_labels": {}, "laser_labels": [],
             "calibrations": {}, "pose": None, "timestamp": 0,
             "context_name": ""}
    for f, wt, v in iter_fields(buf):
        if f == 1:      # context
            for cf, _, cv in iter_fields(v):
                if cf == 1:
                    frame["context_name"] = cv.decode("utf-8", "replace")
                elif cf == 2:  # camera_calibrations
                    calib = {"intrinsic": [], "extrinsic": [], "width": 0,
                             "height": 0, "name": 0}
                    for kf, _, kv in iter_fields(cv):
                        if kf == 1:
                            calib["name"] = int(kv)
                        elif kf == 2:
                            calib["intrinsic"] = _packed_doubles(kv)
                        elif kf == 3:
                            # Transform msg: repeated double transform = 1
                            # (16 row-major values, camera -> vehicle)
                            for tf, _, tv in iter_fields(kv):
                                if tf == 1:
                                    calib["extrinsic"] = _packed_doubles(tv)
                        elif kf == 4:
                            calib["width"] = int(kv)
                        elif kf == 5:
                            calib["height"] = int(kv)
                    frame["calibrations"][calib["name"]] = calib
        elif f == 2:
            frame["timestamp"] = int(v)
        elif f == 3:    # pose
            for pf, _, pv in iter_fields(v):
                if pf == 1:
                    frame["pose"] = _packed_doubles(pv)
        elif f == 4:    # images
            cam, img = 0, b""
            for inf, _, iv in iter_fields(v):
                if inf == 1:
                    cam = int(iv)
                elif inf == 2:
                    img = iv
            frame["images"][cam] = img
        elif f == 6:    # laser_labels (3D boxes)
            frame["laser_labels"].append(_parse_label(v))
        elif f == 8:    # camera_labels
            cam, labels = 0, []
            for cf, _, cv in iter_fields(v):
                if cf == 1:
                    cam = int(cv)
                elif cf == 2:
                    labels.append(_parse_label(cv))
            frame["camera_labels"][cam] = labels
    return frame


# -------------------------------------------------------------- converter

def intrinsic_3x4(vals: List[float]) -> List[List[float]]:
    f_u, f_v, c_u, c_v = (vals + [0.0] * 4)[:4]
    return [[f_u, 0.0, c_u, 0.0], [0.0, f_v, c_v, 0.0],
            [0.0, 0.0, 1.0, 0.0]]


def convert_tfrecord(path: str, out_dir: str,
                     selected_classes=(1, 2, 4)) -> str:
    """One segment TFRecord -> <out_dir>/<segment>/<camera>/... Returns the
    segment directory. ``selected_classes`` keeps VEHICLE, PEDESTRIAN and
    CYCLIST by default, as the JAX package's converter does."""
    segment = os.path.basename(path).split(".tfrecord")[0]
    segment = segment.split("_with_camera_labels")[0]
    sgmt_dir = os.path.join(out_dir, segment)
    for frame_idx, rec in enumerate(iter_tfrecord(path)):
        frame = parse_frame(rec)
        boxes3d, classes3d = [], []
        for lab in frame["laser_labels"]:
            if selected_classes and lab["type"] not in selected_classes:
                continue
            b = lab["box"]
            boxes3d.append([b.get("cx", 0), b.get("cy", 0), b.get("cz", 0),
                            b.get("length", 0), b.get("width", 0),
                            b.get("height", 0), b.get("heading", 0)])
            classes3d.append(TYPE_TO_CLASS.get(lab["type"], 0))
        for cam_id, img_bytes in frame["images"].items():
            cam = CAMERA_NAMES.get(cam_id)
            if cam is None:
                continue
            cam_dir = os.path.join(sgmt_dir, cam)
            os.makedirs(cam_dir, exist_ok=True)
            with open(os.path.join(cam_dir, f"{frame_idx:06d}.jpg"),
                      "wb") as f:
                f.write(img_bytes)
            meta: Dict = {"timestamp": frame["timestamp"]}
            labels = frame["camera_labels"].get(cam_id, [])
            boxes2d, classes2d = [], []
            for lab in labels:
                if selected_classes and lab["type"] not in selected_classes:
                    continue
                b = lab["box"]
                # waymo 2D camera boxes: center (cx, cy), size
                # (length=x extent, width=y extent), absolute pixels
                boxes2d.append([b.get("cx", 0), b.get("cy", 0),
                                b.get("length", 0), b.get("width", 0)])
                classes2d.append(TYPE_TO_CLASS.get(lab["type"], 0))
            meta["boxes2d"] = boxes2d
            meta["classes2d"] = classes2d
            meta["boxes3d"] = boxes3d
            meta["classes3d"] = classes3d
            calib = frame["calibrations"].get(cam_id)
            if calib and calib["intrinsic"]:
                meta["intrinsic"] = intrinsic_3x4(calib["intrinsic"])
            if calib and len(calib.get("extrinsic", [])) == 16:
                # raw camera->vehicle 4x4 in WAYMO axes; the reader converts
                # it to aloception axes
                ext = calib["extrinsic"]
                meta["extrinsic"] = [ext[i * 4:(i + 1) * 4] for i in range(4)]
            if frame["pose"]:
                meta["pose"] = frame["pose"]
            with open(os.path.join(cam_dir, f"{frame_idx:06d}.json"),
                      "w") as f:
                json.dump(meta, f)
    return sgmt_dir


def prepare(tfrecord_dir: str, out_dir: str) -> List[str]:
    """All *.tfrecord under tfrecord_dir -> prepared layout under out_dir,
    one segment directory each, in file name order."""
    paths = sorted(glob(os.path.join(tfrecord_dir, "*.tfrecord")))
    if not paths:
        raise FileNotFoundError(f"no .tfrecord files in {tfrecord_dir}")
    return [convert_tfrecord(p, out_dir) for p in paths]
