"""Training logging (counterpart of ``aloception_tpu/train/logger.py``).

``TensorBoardLogger`` writes TensorBoard's event file itself, with no
TensorBoard package: the JAX package's logger goes through tensorboardX,
which a machine may not have. The file is a sequence of TFRecords (the
length as a little-endian uint64, the masked CRC-32C of those 8 bytes, the
data, the masked CRC-32C of the data), each holding an ``Event`` protocol
buffer encoded here by hand: ``wall_time`` (1, double), ``step`` (2,
int64), ``file_version`` (3, "brain.Event:2" in the first record) or
``summary`` (5). A ``Summary`` holds ``Value``s of a ``tag`` (1) and a
``simple_value`` (2, float) for a scalar, an ``image`` (4: height, width,
colorspace and a PNG made with ``zlib``) or a ``histo`` (5: min, max, num,
sum, sum_squares, bucket_limit, bucket). Tags, the image's conversion to
bytes and the histogram's buckets follow tensorboardX, so that TensorBoard
shows what the JAX logger's files show.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np


class NoOpLogger:
    def log_scalar(self, *a, **kw): pass
    def log_scalars(self, *a, **kw): pass
    def log_image(self, *a, **kw): pass
    def log_hist(self, *a, **kw): pass
    def flush(self): pass
    def close(self): pass


# ------------------------------------------------------------- CRC-32C ----
def _crc32c_table() -> Sequence[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask of the CRC-32C: rotated right by 15, plus a
    constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ------------------------------------------------------ protocol buffers ----
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # negative int64s take ten bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(x))


def _float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _packed_doubles(field: int, xs) -> bytes:
    return _bytes(field, struct.pack(f"<{len(xs)}d", *map(float, xs)))


def event(wall_time: float, step: Optional[int] = None,
          file_version: Optional[str] = None,
          summary: Optional[bytes] = None) -> bytes:
    """An encoded ``Event``."""
    out = _double(1, wall_time)
    if step is not None:
        out += _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def summary_value(tag: str, simple_value: Optional[float] = None,
                  image: Optional[bytes] = None,
                  histo: Optional[bytes] = None) -> bytes:
    """An encoded ``Summary`` of one ``Value``."""
    value = _bytes(1, tag.encode())
    if simple_value is not None:
        value += _float(2, simple_value)
    if image is not None:
        value += _bytes(4, image)
    if histo is not None:
        value += _bytes(5, histo)
    return _bytes(1, value)


_INVALID_TAG = re.compile(r"[^-/\w.]")


def clean_tag(tag: str) -> str:
    """tensorboardX's tag: characters other than word characters, ``-``,
    ``/`` and ``.`` become ``_``, leading slashes go."""
    return _INVALID_TAG.sub("_", tag).lstrip("/")


def png(image: np.ndarray) -> bytes:
    """(H, W, C) uint8, C in 1-4, as a PNG (no filter, zlib level 6)."""
    h, w, c = image.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\0" + row.tobytes()
                   for row in np.ascontiguousarray(image))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def image_proto(image: np.ndarray) -> bytes:
    """``Summary.Image`` of an HWC (or HW) image, as tensorboardX makes it:
    one channel repeated to three, float (in [0, 1]) scaled by 255 and
    truncated to uint8, uint8 as it is."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[2] == 1:
        image = np.concatenate([image] * 3, 2)
    if image.dtype != np.uint8:
        image = (image * 255.0).astype(np.uint8)
    h, w, c = image.shape
    return (_int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, png(image)))


def _default_bins() -> np.ndarray:
    """tensorboardX's default edges: +-1e-12 * 1.1^k up to 1e20, and 0."""
    v, pos = 1e-12, []
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return np.array([-x for x in pos[::-1]] + [0] + pos)


DEFAULT_BINS = _default_bins()


def histogram_proto(values: np.ndarray) -> bytes:
    """``HistogramProto`` of ``values`` as tensorboardX's ``make_histogram``
    builds it: numpy's histogram over the default edges, cut to the buckets
    that hold values with one empty bucket on the left, each bucket by its
    right edge."""
    values = np.asarray(values, dtype=float).reshape(-1)
    if values.size == 0:
        raise ValueError("a histogram of no values")
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(counts > 0)
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = counts[start - 1:end] if start > 0 else np.concatenate(
        [[0], counts[:end]])
    limits = limits[start:end + 1]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, len(values)) + _double(4, values.sum())
            + _double(5, values.dot(values))
            + _packed_doubles(6, limits.tolist())
            + _packed_doubles(7, counts.tolist()))


class EventFileWriter:
    """Appends ``Event`` records to ``<log_dir>/events.out.tfevents.<time>.
    <host>``, the first holding the file version."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
            f".{os.getpid()}")
        self._file = open(self.path, "ab")
        self.write(event(now, step=0, file_version="brain.Event:2"))
        self.flush()

    def write(self, record: bytes):
        self._file.write(tfrecord(record))

    def add_summary(self, summary: bytes, step: Optional[int]):
        self.write(event(time.time(), step=step, summary=summary))

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()


# ---------------------------------------------------------------- reading ----
def _fields(buf: bytes):
    """(field, wire type, value) of an encoded message; a varint's value is
    an int, a length-delimited one bytes, a fixed one its raw bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_events(path: str) -> List[Dict]:
    """The summary values of an event file, in order: dicts of ``step``,
    ``tag`` and ``simple_value`` (a float) or ``image`` (the decoded PNG,
    (H, W, C) uint8); each record's CRCs are checked."""
    from ..runtime import decode_bytes
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        if struct.unpack("<I", data[i + 8:i + 12])[0] != masked_crc32c(head):
            raise ValueError(f"{path}: a record's length CRC does not match")
        rec = data[i + 12:i + 12 + n]
        if struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] \
                != masked_crc32c(rec):
            raise ValueError(f"{path}: a record's data CRC does not match")
        i += 16 + n
        step = 0
        for field, _, value in _fields(rec):
            if field == 2:
                step = value
            if field != 5:
                continue
            for _, _, v in _fields(value):            # Summary.value
                item = {"step": step}
                for vf, _, vv in _fields(v):
                    if vf == 1:
                        item["tag"] = vv.decode()
                    elif vf == 2:
                        item["simple_value"] = struct.unpack("<f", vv)[0]
                    elif vf == 4:
                        enc = dict((f, x) for f, _, x in _fields(vv))[4]
                        item["image"] = decode_bytes(enc, "unchanged"
                                                     ).numpy()
                out.append(item)
    return out


class TensorBoardLogger(NoOpLogger):
    """The JAX package's logger surface over ``EventFileWriter``."""

    def __init__(self, log_dir: str):
        self.writer = EventFileWriter(log_dir)

    def log_scalar(self, name: str, value: float, step: int):
        self.writer.add_summary(
            summary_value(clean_tag(name), simple_value=float(value)), step)

    def log_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        """Each value that converts to a float; the others are skipped."""
        for k, v in scalars.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self.writer.add_summary(
                summary_value(clean_tag(prefix + k), simple_value=value),
                step)

    def log_image(self, name: str, image: np.ndarray, step: int):
        """image: HWC float in [0, 1] (or uint8)."""
        self.writer.add_summary(
            summary_value(clean_tag(name), image=image_proto(image)), step)

    def log_hist(self, name: str, values: np.ndarray, step: int):
        self.writer.add_summary(
            summary_value(clean_tag(name), histo=histogram_proto(
                np.asarray(values))), step)

    def log_figure(self, name: str, figure, step: int):
        """A matplotlib figure, drawn by its Agg canvas."""
        image = _figure_image(figure)
        self.log_image(name, image, step)

    def log_scatter(self, name: str, xs, ys, step: int, xlabel="x",
                    ylabel="y"):
        """A scatter plot drawn by matplotlib."""
        plt = _pyplot()
        fig, ax = plt.subplots()
        ax.scatter(np.asarray(xs), np.asarray(ys), s=4)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        self.log_figure(name, fig, step)
        plt.close(fig)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("log_figure and log_scatter draw with matplotlib, "
                           "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _figure_image(figure) -> np.ndarray:
    """The figure's RGBA pixels, uint8 (H, W, 4)."""
    _pyplot()
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    canvas = FigureCanvasAgg(figure)
    canvas.draw()
    return np.asarray(canvas.buffer_rgba()).copy()


def make_logger(backend: Optional[str], log_dir: Optional[str] = None):
    """The --log switch: "tensorboard" or "tb" writes event files into
    ``log_dir``; None or "none" is the no-op logger."""
    if backend in ("tensorboard", "tb"):
        if log_dir is None:
            raise ValueError("the tensorboard logger needs a log_dir")
        return TensorBoardLogger(log_dir)
    if backend in (None, "none"):
        return NoOpLogger()
    if backend == "wandb":
        print("[logger] wandb unavailable; falling back to tensorboard")
        return make_logger("tensorboard", log_dir)
    raise ValueError(f"unknown logger backend {backend}")
