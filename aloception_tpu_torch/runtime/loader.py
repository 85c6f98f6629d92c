"""Image decoding and the batch loader (counterpart of
``aloception_tpu/runtime/loader.py``, which binds a libjpeg + libpng build).

JPEG and WebP are decoded by Pillow, whose libjpeg-turbo and libwebp give
``cv2.imread``'s pixels (the integer IDCT and the same upsampling); PNG and
BMP by ``aloloader.cpp``, through ctypes, since Pillow reduces 16-bit colour
PNGs to 8 bits. The library is built at its first use in a process, with
the host C++ compiler that ``export.base_exporter.host_compiler`` picks (the
card machine's ``$CXX`` is a partial toolchain), into
``aloception_tpu_torch/_build/libaloloader_<hash>.so``, where ``<hash>`` is
taken from the source and the flags: an edited source is rebuilt, an
unchanged one is loaded as it is. It links zlib only. A failed build raises
with the compiler's message; nothing falls back to another decoder.

Pillow's decoders and ctypes release the interpreter lock while they run,
so threads that decode (the datasets' prefetch workers, the batch loader's
pool) run in parallel.

- ``decode(path, mode)``: one image at its native size, as a uint8 or
  uint16 (H, W, C) tensor, with ``cv2.imread``'s semantics for the mode
  ("color": RGB; "gray"; "anydepth": grey at the stored depth;
  "unchanged"), a JPEG's EXIF orientation applied (except "unchanged"); an
  unreadable or unsupported file raises ``InvalidSampleError`` with the
  reason. A JPEG cut short after its header decodes as cv2's does: the rows
  that arrived, then libjpeg's fill; a CMYK JPEG through cv2's CMYK -> BGR;
  a colour image read as grey through the conversion cv2 applies to its
  format (``aloloader.cpp`` for PNG and BMP, ``_grey15_of_rgb`` for WebP).
- ``decode_bytes(data, mode)``: the same for an encoded image held in
  memory, as ``cv2.imdecode`` gives it (its EXIF orientation applied too).
- ``NativeImageLoader``: threaded decode + bilinear resize + normalize of
  batches (the JAX loader's arithmetic), into one float32 NHWC tensor.
- ``fill_poly``: ``cv2.fillPoly(mask, [xy], 1)`` on a uint8 mask.
- ``resize_linear_u8``: ``cv2.resize(img, (W, H), INTER_LINEAR)`` of a
  uint8 image, bit for bit (cv2's fixed-point path).
- ``alo_mpeg4_intra_vop`` (no wrapper here): the bit packer of the
  renderer's mp4 recording (``aloscene/renderer/video.py::pack_vop``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..aloscene.io.errors import InvalidSampleError

_SRC = Path(__file__).resolve().with_name("aloloader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LINK = ("-lz",)

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
MODES = {"color": 0, "gray": 1, "anydepth": 2, "unchanged": 3}
STATUS = {1: "cannot read the file", 2: "unknown format", 3: "corrupt",
          4: "unsupported"}

_INT = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS + LINK).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libaloloader_{digest}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``aloloader.cpp`` if its library is missing, then load it and
    declare its functions. Raises ``RuntimeError`` with the compiler's
    output if the build fails."""
    out = library_path()
    if not out.exists():
        from ..export.base_exporter import host_compiler
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [host_compiler(), *CXX_FLAGS, str(_SRC), *LINK, "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building aloloader.cpp failed (exit "
                               f"{res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(out))
    lib.alo_decode.restype = ctypes.c_int
    lib.alo_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, _INT, _INT, _INT,
                               _INT, ctypes.POINTER(ctypes.c_void_p),
                               ctypes.c_char_p, ctypes.c_int]
    lib.alo_free.restype = None
    lib.alo_free.argtypes = [ctypes.c_void_p]
    lib.alo_resize_normalize.restype = None
    lib.alo_resize_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.alo_decode_buffer.restype = ctypes.c_int
    lib.alo_decode_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _INT, _INT, _INT,
        _INT, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int]
    lib.alo_fill_poly.restype = None
    lib.alo_fill_poly.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int]
    lib.alo_resize_linear_u8.restype = None
    lib.alo_resize_linear_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for fn in (lib.alo_line, lib.alo_rectangle):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_int64] * 4 + [
                           ctypes.c_void_p, ctypes.c_int]
    lib.alo_mpeg4_intra_vop.restype = ctypes.c_int64
    lib.alo_mpeg4_intra_vop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    return lib


def _orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """EXIF orientation 1-8 -> the upright (H, W, C) image, as cv2.imread
    turns it: transpose for 5-8, then flips."""
    if orientation >= 5:
        img = img.transpose(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img.flip(1)
    if orientation in (3, 4, 7, 8):
        img = img.flip(0)
    return img.contiguous()


def _format_of(head: bytes) -> str:
    """"JPEG", "WebP" or "native" (the rest: PNG, BMP, or refused by the
    native decoder) by an image's first bytes."""
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "native"


def _format(path: str) -> str:
    try:
        with open(path, "rb") as f:
            return _format_of(f.read(12))
    except OSError:
        return "native"           # the native decoder names the reason


# what libjpeg's stdio source hands out, again and again, once a file has
# ended: cv2 decodes a truncated JPEG followed by these bytes. Enough copies
# to complete the longest marker segment (65,535 bytes) the cut may fall in.
EOI = b"\xff\xd9"
EOI_FILL = EOI * 32769


def _grey15_of_rgb(rgb: np.ndarray) -> np.ndarray:
    """cv2's ``cvtColor(COLOR_BGR2GRAY)`` of an (H, W, 3) uint8 RGB image,
    its 15-bit fixed point: what ``cv2.imread`` gives for a colour WebP read
    as grey (it decodes in colour first)."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
            ).astype(np.uint8)


def _rgb_of_cmyk(cmyk: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_CMYK2BGR`` of libjpeg's CMYK output (Adobe's inverted
    convention, as stored), as RGB: each of C, M, Y becomes
    ``k - ((255 - x) * k >> 8)``."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    return (k - ((255 - x[..., :3]) * k >> 8)).astype(np.uint8)


def _grey14_of_rgb(rgb: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_BGR2Gray`` (14-bit fixed point) of an (H, W, 3) uint8
    RGB image: the grey of a CMYK JPEG after ``_rgb_of_cmyk``."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + (1 << 13)) >> 14
            ).astype(np.uint8)


def _decode_pillow(path: str, mode: str, fmt: str, data: bytes = None
                   ) -> torch.Tensor:
    """A JPEG (8-bit grey, YCbCr or CMYK) or WebP as ``cv2.imread`` gives
    it, read from ``path`` or, given, from ``data`` (``path`` then names it
    in errors). A JPEG's "gray" comes from libjpeg's own grey output, as
    cv2's does. The JPEG's bytes reach Pillow followed by EOI markers, as
    libjpeg's stdio source hands them out past the end of a file for cv2: a
    truncated file then decodes to the same pixels, and a whole one stops at
    its own EOI; Pillow's process-wide ``LOAD_TRUNCATED_IMAGES`` is left
    alone."""
    def refuse(why):
        return InvalidSampleError(f"image decoder: cannot read {path}: {why}")
    grey = mode in ("gray", "anydepth")
    try:
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        if fmt == "JPEG":
            data += EOI_FILL
        with Image.open(io.BytesIO(data)) as im:
            if im.format != fmt.upper():
                raise refuse(f"unknown format: {im.format}")
            if fmt == "JPEG" and im.mode not in ("L", "RGB", "CMYK"):
                raise refuse(f"unsupported: a JPEG in mode {im.mode}")
            if grey and im.mode == "RGB" and fmt == "JPEG":
                im.draft("L", im.size)
            orientation = 1
            if fmt == "JPEG" and mode != "unchanged":
                orientation = int(im.getexif().get(0x0112, 1))
            im.load()
            arr = np.array(im)
            src = im.mode
    except InvalidSampleError:
        raise
    except Exception as e:      # Pillow's errors: OSError, SyntaxError, ...
        raise refuse(f"corrupt {fmt}: {e}") from e
    if src == "CMYK":           # Pillow inverts it on reading: undo that
        arr = _rgb_of_cmyk(255 - arr)
        if grey:
            arr = _grey14_of_rgb(arr)
    elif grey and arr.ndim == 3:
        arr = _grey15_of_rgb(arr[..., :3])
    elif mode == "color" and src != "RGB":
        arr = arr[..., None].repeat(3, -1) if arr.ndim == 2 else arr[..., :3]
    img = torch.from_numpy(np.ascontiguousarray(
        arr if arr.ndim == 3 else arr[..., None]))
    return img if orientation == 1 else _orient(img, orientation)


def decode(path: str, mode: str = "color") -> torch.Tensor:
    """Decode ``path`` (JPEG, WebP, PNG or BMP) at its native size -> (H, W,
    C) uint8, or uint16 for a 16-bit PNG in "anydepth"/"unchanged" mode, on
    the CPU."""
    fmt = _format(path)
    if fmt != "native":
        return _decode_pillow(path, mode, fmt)
    return _decode_native(
        path, lambda lib, *out: lib.alo_decode(os.fsencode(path),
                                               MODES[mode], *out))


def decode_bytes(data: bytes, mode: str = "color") -> torch.Tensor:
    """``decode`` of an encoded image held in memory, as ``cv2.imdecode``
    gives it: cv2 applies a JPEG's EXIF orientation there as ``imread``
    does, and so does this."""
    data = bytes(data)
    fmt = _format_of(data[:12])
    if fmt != "native":
        return _decode_pillow("<bytes>", mode, fmt, data)
    return _decode_native(
        "<bytes>", lambda lib, *out: lib.alo_decode_buffer(
            data, len(data), MODES[mode], *out))


def _decode_native(name: str, call) -> torch.Tensor:
    """Run ``call(lib, h, w, c, nbytes, data, err, errlen)`` (an
    ``alo_decode`` entry) and wrap what it hands out as a tensor."""
    lib = load_library()
    h, w, c, nbytes = (ctypes.c_int() for _ in range(4))
    data = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = call(lib, h, w, c, nbytes, ctypes.byref(data), err, len(err))
    if rc != 0:
        raise InvalidSampleError(
            f"image decoder: cannot read {name}: {STATUS.get(rc, rc)}: "
            f"{err.value.decode(errors='replace')}")
    try:
        n = h.value * w.value * c.value
        dtype = np.uint8 if nbytes.value == 1 else np.uint16
        arr = np.ctypeslib.as_array(
            ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)),
            (n * nbytes.value,)).view(dtype).reshape(h.value, w.value,
                                                    c.value)
        return torch.from_numpy(arr.copy())
    finally:
        lib.alo_free(data)


def fill_poly(mask: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Set the pixels of the polygon ``xy`` ((N, 2) integer x, y) to 1 in
    the C-contiguous (H, W) uint8 ``mask``, in place, as ``cv2.fillPoly``
    does (8-connected edges, integer vertices); returns ``mask``."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or \
            not mask.flags["C_CONTIGUOUS"]:
        raise ValueError("fill_poly needs a C-contiguous (H, W) uint8 mask")
    pts = np.ascontiguousarray(xy, np.int32).reshape(-1, 2)
    load_library().alo_fill_poly(mask.ctypes.data, mask.shape[0],
                                 mask.shape[1], pts.ctypes.data, len(pts))
    return mask


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)`` of an
    (h, w) or (h, w, c) uint8 image to ``size`` = (H, W), bit for bit: cv2's
    fixed-point arithmetic for 8-bit images (``aloloader.cpp``)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("resize_linear_u8 needs an (h, w[, c]) uint8 image")
    src = np.ascontiguousarray(img)
    c = 1 if src.ndim == 2 else src.shape[2]
    H, W = (int(v) for v in size)
    if min(H, W, *src.shape) <= 0:
        raise ValueError(f"cannot resize a {src.shape} image to {(H, W)}")
    out = np.empty((H, W) + src.shape[2:], np.uint8)
    load_library().alo_resize_linear_u8(src.ctypes.data, src.shape[0],
                                        src.shape[1], c, out.ctypes.data, H, W)
    return out


class NativeImageLoader:
    """Threaded decode + resize + normalize of image batches (the JAX
    ``NativeImageLoader``'s arithmetic, in native code: bilinear with
    half-pixel centres, edge-clamped). ``mode``: "raw" (0..255), "01", or
    "resnet" ((x/255 - mean) / std)."""

    MODES = {"raw": 0, "01": 1, "resnet": 2}

    def __init__(self, size: Tuple[int, int], mode: str = "resnet",
                 mean=RESNET_MEAN, std=RESNET_STD, n_threads: int = 8):
        self.lib = load_library()
        self.size = tuple(size)
        self.mode = self.MODES[mode]
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)
        self.n_threads = n_threads

    def _load_into(self, path: str, out: torch.Tensor):
        img = decode(path, "color").contiguous()
        h, w = self.size
        self.lib.alo_resize_normalize(
            img.data_ptr(), img.shape[0], img.shape[1], out.data_ptr(), h, w,
            self.mode, self.mean.ctypes.data, self.std.ctypes.data)

    def load_batch(self, paths: Sequence[str]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """paths -> ((N, H, W, 3) float32 NHWC, (N,) bool ok-mask); a file
        that does not decode is left as zeros and marked False."""
        n = len(paths)
        h, w = self.size
        out = torch.zeros((n, h, w, 3), dtype=torch.float32)

        def one(i):
            try:
                self._load_into(paths[i], out[i])
                return True
            except InvalidSampleError:
                out[i].zero_()
                return False
        with ThreadPoolExecutor(max(1, min(self.n_threads, n))) as pool:
            ok = list(pool.map(one, range(n)))
        return out, torch.tensor(ok, dtype=torch.bool)

    def load(self, path: str) -> torch.Tensor:
        """One image; a file that does not decode raises
        ``InvalidSampleError`` with the decoder's reason."""
        out = torch.zeros((*self.size, 3), dtype=torch.float32)
        self._load_into(path, out)
        return out
