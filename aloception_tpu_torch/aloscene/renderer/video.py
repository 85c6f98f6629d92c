"""MP4 recording without OpenCV: an MPEG-4 Part 2 ("mp4v", ISO/IEC
14496-2) encoder that writes intra VOPs only, and the ISO base-media file
around it (ISO/IEC 14496-12 and 14496-14). It stands in for the JAX
renderer's ``cv2.VideoWriter(path, fourcc("mp4v"), fps, (W, H))``.

A frame is the uint8 RGB picture the JAX renderer hands cv2 (there as
BGR). It is cropped to even sizes from the top-left, as cv2's FFmpeg
writer crops it, converted to Y'CbCr by BT.601 in limited range with 4:2:0
chroma (each chroma sample the mean of its 2x2 pixels), padded to whole
16x16 macroblocks by replicating the edge, and coded as one I-VOP at the
fixed quantiser ``QP``: the 8x8 DCT, the intra DC quantised by the DC
scaler of ``QP`` and predicted from the left, upper-left and upper blocks
(14496-2 7.4.3), the AC coefficients quantised as H.263 intra
(``|c| // (2 QP)``, quant_type 0) in zig-zag order and coded as (last, run,
level) events with the intra TCOEF table of Annex B and its three escapes.

The colour conversion, the DCT, the quantisation and the reconstruction
are numpy in float64 (``encode_intra``); the macroblock loop (DC
prediction, the VLCs, the bit packing) is ``alo_mpeg4_intra_vop`` in
``runtime/aloloader.cpp`` (``pack_vop``). ``pack_vop_python`` is the same
loop written bit by bit, which the tests hold the native packer to; the
recording never takes it. The tables below are written out from Annex B of
14496-2 and passed to the packer, so both packers code with one copy.

The file holds ``ftyp``, one ``mdat`` written as the frames arrive, and at
``release`` the ``moov``: one video track whose ``mp4v`` sample entry
carries the visual object sequence, visual object and video object layer
headers in its ``esds``, every sample a sync sample, all samples one
chunk. ``read_mp4`` reads such a file back.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

QP = 3      # the fixed quantiser; see tests/test_torch_video.py's contents

# ---------------------------------------------------------------------------
# Annex B tables: variable-length codes as bit strings
# ---------------------------------------------------------------------------
# Table B-6: mcbpc of I-VOPs, macroblock type 3 (intra), by cbpc (Cb, Cr)
MCBPC_INTRA = ("1", "001", "010", "011")
# Table B-8: cbpy of intra macroblocks, by the pattern of blocks 0-3 (MSB 0)
CBPY = ("0011", "00101", "00100", "1001", "00011", "0111", "000010",
        "1011", "00010", "000011", "0101", "1010", "0100", "1000", "0110",
        "11")
# Tables B-13 and B-14: dct_dc_size_luminance / _chrominance, by size
DC_SIZE_LUMINANCE = ("011", "11", "10", "010", "001", "0001", "00001",
                     "000001", "0000001", "00000001", "000000001",
                     "0000000001", "00000000001")
DC_SIZE_CHROMINANCE = ("11", "10", "01", "001", "0001", "00001", "000001",
                       "0000001", "00000001", "000000001", "0000000001",
                       "00000000001", "000000000001")
# Table B-16: intra TCOEF, {(last, run): codes of level 1, 2, ...}; each
# code is followed by the level's sign bit (0 positive)
INTRA_TCOEF = {
    (0, 0): ("10", "110", "1111", "01101", "01100", "010101", "010011",
             "010010", "0010111", "00011111", "00011110", "00011101",
             "000100101", "000100100", "000100011", "000100001",
             "0000100001", "0000100000", "0000001111", "0000001110",
             "00000000111", "00000000110", "00000100000", "00000100001",
             "000001010000", "000001010001", "000001010010"),
    (0, 1): ("1110", "010100", "0010110", "00011100", "000100000",
             "000011111", "0000001101", "00000100010", "000001010011",
             "000001010101"),
    (0, 2): ("01011", "0010101", "000011110", "0000001100",
             "000001010110"),
    (0, 3): ("010001", "00011011", "000011101", "0000001011"),
    (0, 4): ("010000", "000100010", "0000001010"),
    (0, 5): ("001101", "000011100", "0000001000"),
    (0, 6): ("0010010", "000011011", "000001010100"),
    (0, 7): ("0010100", "000011010", "000001010111"),
    (0, 8): ("00011001", "0000001001"),
    (0, 9): ("00011000", "00000100011"),
    (0, 10): ("00010111",),
    (0, 11): ("000011001",),
    (0, 12): ("000011000",),
    (0, 13): ("0000000111",),
    (0, 14): ("000001011000",),
    (1, 0): ("0111", "001100", "00010110", "000010111", "0000000110",
             "00000000101", "00000000100", "000001011001"),
    (1, 1): ("001111", "000010110", "0000000101"),
    (1, 2): ("001110", "0000000100"),
    (1, 3): ("0010001", "00000100100"),
    (1, 4): ("0010000", "00000100101"),
    (1, 5): ("0010011", "000001011010"),
    (1, 6): ("00010101", "000001011011"),
    (1, 7): ("00010100",),
    (1, 8): ("00010011",),
    (1, 9): ("00011010",),
    (1, 10): ("000010101",),
    (1, 11): ("000010100",),
    (1, 12): ("000010011",),
    (1, 13): ("000010010",),
    (1, 14): ("000010001",),
    (1, 15): ("00000100110",),
    (1, 16): ("00000100111",),
    (1, 17): ("000001011100",),
    (1, 18): ("000001011101",),
    (1, 19): ("000001011110",),
    (1, 20): ("000001011111",),
}
ESCAPE = "0000011"
MAX_LEVEL = 32          # the packed TCOEF table's levels: 0-31 (27 used)

# offsets into the packed table (``packed_tables``), which the packer in
# aloloader.cpp reads at the same offsets
T_MCBPC, T_CBPY, T_DC_LUM, T_DC_CHROM, T_TCOEF = 0, 4, 20, 33, 46
T_SIZE = T_TCOEF + 2 * 64 * MAX_LEVEL


def _entry(code: str) -> int:
    """A code as the packer reads it: value << 8 | length."""
    return int(code, 2) << 8 | len(code)


def packed_tables() -> np.ndarray:
    """The VLC tables as one uint32 array (``_entry`` each, 0 where the
    TCOEF table has no code): MCBPC, CBPY, the two DC sizes, then TCOEF
    indexed ``T_TCOEF + (last * 64 + run) * MAX_LEVEL + level``."""
    t = np.zeros(T_SIZE, np.uint32)
    for off, codes in ((T_MCBPC, MCBPC_INTRA), (T_CBPY, CBPY),
                       (T_DC_LUM, DC_SIZE_LUMINANCE),
                       (T_DC_CHROM, DC_SIZE_CHROMINANCE)):
        t[off:off + len(codes)] = [_entry(c) for c in codes]
    for (last, run), codes in INTRA_TCOEF.items():
        for level, code in enumerate(codes, 1):
            t[T_TCOEF + (last * 64 + run) * MAX_LEVEL + level] = _entry(code)
    return t


def _lmax(last: int, run: int) -> int:
    return len(INTRA_TCOEF.get((last, run), ()))


def _rmax(last: int, level: int) -> int:
    """The longest run with a code for ``level`` (-1: none)."""
    return max((run for (l_, run), codes in INTRA_TCOEF.items()
                if l_ == last and len(codes) >= level), default=-1)


# ---------------------------------------------------------------------------
# colour, DCT, quantisation (numpy, float64)
# ---------------------------------------------------------------------------
KR, KB = 0.299, 0.114
KG = 1 - KR - KB


def luma_of_rgb(rgb: np.ndarray) -> np.ndarray:
    """BT.601 limited-range Y' (16-235), float64, of (..., 3) RGB 0-255."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    return 16 + 219 / 255 * (KR * r + KG * g + KB * b)


def _to_u8(p: np.ndarray) -> np.ndarray:
    """Round half up and clip to uint8 (in place on the float ``p``)."""
    p += 0.5
    np.floor(p, out=p)
    return np.clip(p, 0, 255, out=p).astype(np.uint8)


def ycbcr_of_rgb(rgb: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(Y', Cb, Cr) of an (H, W, 3) RGB picture with even H and W, as
    uint8 planes: Y' at full size, Cb and Cr at half size, each the value
    of its 2x2 pixels' mean (the mean of their Cb and Cr: the map is
    linear)."""
    x = rgb.astype(np.float64)
    luma = np.array([KR, KG, KB])
    y = x @ (219 / 255 * luma)
    y += 16
    half = x[0::2, 0::2] + x[0::2, 1::2]
    half += x[1::2, 0::2]
    half += x[1::2, 1::2]
    half *= 0.25
    e = half @ luma
    cb = (half[..., 2] - e) * (224 / 255 / (2 * (1 - KB))) + 128
    cr = (half[..., 0] - e) * (224 / 255 / (2 * (1 - KR))) + 128
    return _to_u8(y), _to_u8(cb), _to_u8(cr)


def rgb_of_ycbcr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                 ) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of 4:2:0 planes, each chroma sample covering
    its 2x2 pixels (the inverse of ``ycbcr_of_rgb``'s matrix)."""
    up = [np.repeat(np.repeat(c.astype(np.float64) - 128, 2, 0), 2, 1)
          for c in (cb, cr)]
    e = (y.astype(np.float64) - 16) * 255 / 219
    pb, pr = (c * 255 / 224 for c in up)
    r = e + 2 * (1 - KR) * pr
    b = e + 2 * (1 - KB) * pb
    g = (e - KR * r - KB * b) / KG
    rgb = np.stack([r, g, b], -1)
    return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)


def psnr(got: np.ndarray, want: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB of two uint8-range arrays (inf when
    equal)."""
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255 ** 2 / mse))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


DCT = _dct_matrix()          # F = DCT @ f @ DCT.T, F[0, 0] = sum(f) / 8


def _zigzag() -> np.ndarray:
    """Raster index of each coefficient in the classic zig-zag scan."""
    order = sorted(((u + v, u if (u + v) % 2 else v, u * 8 + v)
                    for u in range(8) for v in range(8)))
    return np.array([i for _, _, i in order])


ZIGZAG = _zigzag()


def dc_scaler(qp: int, luminance: bool) -> int:
    """Table 7-1 of 14496-2: the intra DC quantiser of ``qp``."""
    if qp <= 4:
        return 8
    if luminance:
        return 2 * qp if qp <= 8 else qp + 8 if qp <= 24 else 2 * qp - 16
    return (qp + 13) // 2 if qp <= 24 else qp - 6


def _scalers(qp: int) -> np.ndarray:
    return np.array([dc_scaler(qp, True)] * 4 + [dc_scaler(qp, False)] * 2,
                    np.float64)


def _blocks(y, cb, cr) -> np.ndarray:
    """(mb_h, mb_w, 6, 8, 8) float64 blocks of macroblock-padded planes in
    coding order: Y' top-left, top-right, bottom-left, bottom-right, Cb,
    Cr."""
    mh, mw = cb.shape[0] // 8, cb.shape[1] // 8
    luma = y.reshape(mh, 2, 8, mw, 2, 8).transpose(0, 3, 1, 4, 2, 5)
    chroma = [c.reshape(mh, 8, mw, 8).transpose(0, 2, 1, 3)[:, :, None]
              for c in (cb, cr)]
    return np.concatenate([luma.reshape(mh, mw, 4, 8, 8)] + chroma,
                          2).astype(np.float64)


def _planes(blocks: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The inverse of ``_blocks``."""
    mh, mw = blocks.shape[:2]
    y = blocks[:, :, :4].reshape(mh, mw, 2, 2, 8, 8).transpose(
        0, 2, 4, 1, 3, 5).reshape(mh * 16, mw * 16)
    return (y,) + tuple(blocks[:, :, k].transpose(0, 2, 1, 3).reshape(
        mh * 8, mw * 8) for k in (4, 5))


class IntraPicture(NamedTuple):
    """What ``encode_intra`` gives: the quantised levels, (n_mb, 6, 64)
    int16 in zig-zag order with each block's quantised DC first, the
    macroblocks across and down, and the decoder's reconstruction of the
    (even-cropped) picture as uint8 Y', Cb and Cr planes."""
    levels: np.ndarray
    mb_size: Tuple[int, int]          # (mb_h, mb_w)
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


def encode_intra(rgb: np.ndarray, qp: int = QP) -> IntraPicture:
    """Quantise an (H, W, 3) uint8 RGB picture with even H and W as one
    intra VOP at ``qp``, with its reconstruction (``reconstruct``)."""
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"encode_intra needs even sizes, not {h}x{w}")
    mh, mw = -(-h // 16), -(-w // 16)
    padded = np.pad(rgb, ((0, mh * 16 - h), (0, mw * 16 - w), (0, 0)),
                    mode="edge")
    coef = DCT @ _blocks(*ycbcr_of_rgb(padded)) @ DCT.T
    dc = coef[..., 0, 0] / _scalers(qp)
    q = coef
    q /= 2 * qp                        # AC: sign(c) * (|c| // (2 qp))
    np.trunc(q, out=q)
    np.clip(q, -2047, 2047, out=q)
    q[..., 0, 0] = np.floor(dc + 0.5)
    levels = q.reshape(mh * mw, 6, 64)[:, :, ZIGZAG].astype(np.int16)
    return IntraPicture(levels, (mh, mw), *_decoded(q, qp, (h, w)))


def reconstruct(levels: np.ndarray, mb_size: Tuple[int, int], qp: int,
                hw: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
    """The decoder's picture of ``levels`` (``IntraPicture.levels``),
    cropped to ``hw``, as uint8 Y', Cb and Cr planes."""
    mh, mw = mb_size
    q = np.zeros((mh, mw, 6, 64))
    q[..., ZIGZAG] = levels.reshape(mh, mw, 6, 64)
    return _decoded(q.reshape(mh, mw, 6, 8, 8), qp, hw)


def _decoded(q: np.ndarray, qp: int, hw: Tuple[int, int]
             ) -> Tuple[np.ndarray, ...]:
    """The inverse quantisation of 14496-2 7.4.4.2 (its second method; the
    intra DC times its scaler) of (mh, mw, 6, 8, 8) levels in raster order,
    the float64 inverse DCT, rounded and clipped, cropped to ``hw``."""
    rec = np.abs(q)
    rec *= 2 * qp
    rec += qp - (1 - qp % 2)
    rec *= np.sign(q)                  # 0 where the level is 0
    rec[..., 0, 0] = q[..., 0, 0] * _scalers(qp)
    np.clip(rec, -2048, 2047, out=rec)
    y, cb, cr = (_to_u8(p) for p in _planes(DCT.T @ rec @ DCT))
    h, w = hw
    return y[:h, :w], cb[:h // 2, :w // 2], cr[:h // 2, :w // 2]


# ---------------------------------------------------------------------------
# one VOP's bits
# ---------------------------------------------------------------------------
class VopTime(NamedTuple):
    """A VOP's time fields: whole seconds since the previous VOP's second
    (``modulo_time_base``), ``vop_time_increment`` and its bit width."""
    seconds: int
    increment: int
    bits: int


def _check_levels(levels: np.ndarray, mb_size, qp: int) -> np.ndarray:
    """``levels`` as the packers take them: C-contiguous (n_mb, 6, 64)
    int16, every intra DC in [0, 2047] once scaled, every AC level in
    [-2047, 2047], at a ``qp`` of 1-31."""
    levels = np.ascontiguousarray(levels)
    mh, mw = mb_size
    if levels.dtype != np.int16 or levels.shape != (mh * mw, 6, 64):
        raise ValueError(f"levels must be ({mh * mw}, 6, 64) int16, not "
                         f"{levels.shape} {levels.dtype}")
    if not 1 <= qp <= 31:
        raise ValueError(f"the quantiser must lie in [1, 31], not {qp}")
    dc = levels[..., 0] * _scalers(qp)
    if dc.min() < 0 or dc.max() > 2047 or \
            np.abs(levels[..., 1:].astype(np.int32)).max() > 2047:
        raise ValueError("an intra DC outside [0, 2047] once scaled, or an "
                         "AC level beyond 2047")
    return levels


def pack_vop(levels: np.ndarray, mb_size: Tuple[int, int], qp: int,
             time: VopTime) -> bytes:
    """One I-VOP (start code to the stuffing) from ``encode_intra``'s
    levels, packed by ``alo_mpeg4_intra_vop`` in ``runtime/aloloader.cpp``
    (built at first use; a failed build raises)."""
    from ...runtime.loader import load_library
    levels = _check_levels(levels, mb_size, qp)
    mh, mw = mb_size
    cap = mh * mw * 1440 + time.seconds // 8 + 64
    out = np.empty(cap, np.uint8)
    n = load_library().alo_mpeg4_intra_vop(
        levels.ctypes.data, mw, mh, qp, time.seconds, time.increment,
        time.bits, _TABLES.ctypes.data, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"the VOP outgrew its {cap}-byte buffer")
    return out[:n].tobytes()


def pack_vop_python(levels: np.ndarray, mb_size: Tuple[int, int], qp: int,
                    time: VopTime) -> bytes:
    """``pack_vop`` written bit by bit in Python, with the same tables: the
    reference the tests hold the native packer to."""
    levels = _check_levels(levels, mb_size, qp)
    mh, mw = mb_size
    bits: List[str] = []

    def put(value: int, n: int):
        bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    put(0x1B6, 32)
    put(0, 2)                                   # vop_coding_type: I
    bits.append("1" * time.seconds + "0")       # modulo_time_base
    put(1, 1)
    put(time.increment, time.bits)
    put(1, 1)
    put(1, 1)                                   # vop_coded
    put(0, 3)                                   # intra_dc_vlc_thr: always
    put(qp, 5)
    scale = [dc_scaler(qp, True), dc_scaler(qp, False)]
    # the reconstructed DC of every block, by plane, 1024 outside the VOP
    dcs = [np.full((2 * mh + 1, 2 * mw + 1), 1024)] + \
        [np.full((mh + 1, mw + 1), 1024) for _ in range(2)]
    for m in range(mh * mw):
        r, c = divmod(m, mw)
        blocks = levels[m].astype(int)
        coded = [bool(b[1:].any()) for b in blocks]
        bits.append(MCBPC_INTRA[coded[4] * 2 + coded[5]])
        put(0, 1)                               # ac_pred_flag
        bits.append(CBPY[coded[0] * 8 + coded[1] * 4 + coded[2] * 2
                         + coded[3]])
        for k in range(6):
            plane, (br, bc) = (0, (2 * r + k // 2, 2 * c + k % 2)) if k < 4 \
                else (k - 3, (r, c))
            f = dcs[plane]
            # +1: row and column 0 of ``f`` are the border
            a, b, cc = (int(v) for v in (f[br + 1, bc], f[br, bc],
                                         f[br, bc + 1]))
            pred = cc if abs(a - b) < abs(b - cc) else a
            s = scale[k >= 4]
            diff = int(blocks[k][0]) - (pred + s // 2) // s
            f[br + 1, bc + 1] = int(blocks[k][0]) * s
            size = abs(diff).bit_length()
            bits.append((DC_SIZE_LUMINANCE if k < 4
                         else DC_SIZE_CHROMINANCE)[size])
            if size:
                put(diff if diff > 0 else diff - 1, size)
                if size > 8:
                    put(1, 1)
            if coded[k]:
                _events(bits, blocks[k])
    bits.append("0")                            # next_start_code stuffing
    bits.append("1" * (-len("".join(bits)) % 8))
    s = "".join(bits)
    return int(s, 2).to_bytes(len(s) // 8, "big")


def _events(bits: List[str], block: np.ndarray):
    """A block's AC levels as (last, run, level) events, each by the table
    or escape 1 (level - LMAX), escape 2 (run - RMAX - 1) or escape 3."""
    nz = [i for i in range(1, 64) if block[i]]
    prev = 0
    for j, i in enumerate(nz):
        last, run, level = int(j == len(nz) - 1), i - prev - 1, int(block[i])
        prev = i
        lv, sign = abs(level), str(int(level < 0))
        codes = INTRA_TCOEF.get((last, run), ())
        lmax, rmax = len(codes), _rmax(last, lv)
        if lv <= len(codes):
            bits += [codes[lv - 1], sign]
        elif lmax and lv - lmax <= lmax:
            bits += [ESCAPE, "0", codes[lv - lmax - 1], sign]
        elif rmax >= 0 and lv <= _lmax(last, run - rmax - 1):
            bits += [ESCAPE, "10",
                     INTRA_TCOEF[(last, run - rmax - 1)][lv - 1], sign]
        else:
            bits += [ESCAPE, "11", str(last), format(run, "06b"), "1",
                     format(level & 0xFFF, "012b"), "1"]


_TABLES = packed_tables()


# ---------------------------------------------------------------------------
# the headers and the container
# ---------------------------------------------------------------------------
def time_base(fps) -> Tuple[int, int]:
    """(vop_time_increment_resolution, fixed_vop_time_increment): ticks a
    second and ticks a frame, ``fps`` as their ratio."""
    f = Fraction(fps).limit_denominator(1001)
    if f < 1 or f.numerator > 65535:
        raise ValueError(f"fps must lie in [1, 65535], not {fps}")
    return f.numerator, f.denominator


def _bit_width(resolution: int) -> int:
    """Bits of vop_time_increment: those of resolution - 1, at least 1."""
    return max((resolution - 1).bit_length(), 1)


def vop_time(k: int, resolution: int, increment: int) -> VopTime:
    """The time fields of the ``k``-th VOP at ``increment`` ticks a frame
    and ``resolution`` ticks a second."""
    t = k * increment
    before = (k - 1) * increment // resolution if k else 0
    return VopTime(t // resolution - before, t % resolution,
                   _bit_width(resolution))


def _stuff(bits: List[str]) -> bytes:
    """The bits, then next_start_code's stuffing: a 0, then 1s to the byte."""
    s = "".join(bits) + "0"
    s += "1" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big")


def stream_headers(width: int, height: int, resolution: int,
                   increment: int) -> bytes:
    """The visual object sequence (Simple Profile, level 1), visual object
    and video object, and the video object layer: rectangular,
    ``resolution`` ticks a second, a fixed VOP rate of ``increment`` ticks,
    progressive, OBMC off, 8 bits, H.263 quantisation, no resync markers,
    no data partitioning, no scalability."""
    vos = struct.pack(">IB", 0x1B0, 0x01)
    vo = _stuff(["00000000000000000000000110110101",       # 0x1B5
                 "0",                 # is_visual_object_identifier
                 "0001",              # visual_object_type: video
                 "0"])                # video_signal_type
    video_object = struct.pack(">I", 0x100)
    tb = _bit_width(resolution)

    def f(value, n):
        return format(value, f"0{n}b")
    vol = _stuff([f(0x120, 32),
                  "0",                # random_accessible_vol
                  f(1, 8),            # video_object_type: Simple Object
                  "0",                # is_object_layer_identifier
                  f(1, 4),            # aspect_ratio_info: square pixels
                  "0",                # vol_control_parameters
                  "00",               # video_object_layer_shape: rectangular
                  "1", f(resolution, 16), "1",
                  "1", f(increment, tb),  # fixed_vop_rate, its increment
                  "1", f(width, 13), "1", f(height, 13), "1",
                  "0",                # interlaced
                  "1",                # obmc_disable
                  "0",                # sprite_enable
                  "0",                # not_8_bit
                  "0",                # quant_type: H.263
                  "1",                # complexity_estimation_disable
                  "1",                # resync_marker_disable
                  "0",                # data_partitioned
                  "0"])               # scalability
    return vos + vo + video_object + vol


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", flags), *parts)   # version 0


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor (14496-1): tag, the size in 7-bit groups."""
    n = len(body)
    size = [n & 0x7F]
    while n > 0x7F:
        n >>= 7
        size.insert(0, 0x80 | (n & 0x7F))
    return bytes([tag] + size) + body


UNITY = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
FTYP = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isom", b"iso2",
            b"mp41")
MDAT_HEADER = 16               # size 1, "mdat", a 64-bit size


def _moov(width, height, resolution, increment, headers, sizes,
          chunk_offset) -> bytes:
    n = len(sizes)
    duration = n * increment
    mvhd = _full_box(b"mvhd", 0, struct.pack(
        ">IIIIIH10x", 0, 0, resolution, duration, 0x10000, 0x100), UNITY,
        bytes(24), struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 3, struct.pack(
        ">III4xI8xHHHH", 0, 0, 1, duration, 0, 0, 0, 0), UNITY,
        struct.pack(">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, struct.pack(
        ">IIIIHH", 0, 0, resolution, duration, 0x55C4, 0))   # "und"
    hdlr = _full_box(b"hdlr", 0, bytes(4), b"vide", bytes(12),
                     b"VideoHandler\0")
    vmhd = _full_box(b"vmhd", 1, bytes(8))
    dinf = _box(b"dinf", _full_box(b"dref", 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 1)))
    bitrate = min(int(sum(sizes) * 8 * resolution / max(duration, 1)),
                  0xFFFFFFFF)
    esds = _full_box(b"esds", 0, _descriptor(3, struct.pack(">HB", 1, 0) + (
        _descriptor(4, struct.pack(
            ">BB", 0x20, 0x04 << 2 | 1)        # MPEG-4 visual, visual stream
            + min(max(sizes, default=0), 0xFFFFFF).to_bytes(3, "big")
            + struct.pack(">II", bitrate, bitrate)
            + _descriptor(5, headers)))
        + _descriptor(6, b"\x02")))
    name = b"aloception mp4v"
    mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHII4xH", width, height, 0x480000, 0x480000,
                            1),
                bytes([len(name)]) + name.ljust(31, b"\0"),
                struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(
        b"stbl",
        _full_box(b"stsd", 0, struct.pack(">I", 1), mp4v),
        _full_box(b"stts", 0, struct.pack(">III", 1, n, increment)),
        _full_box(b"stss", 0, struct.pack(f">I{n}I", n, *range(1, n + 1))),
        _full_box(b"stsc", 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full_box(b"stsz", 0, struct.pack(f">II{n}I", 0, n, *sizes)),
        _full_box(b"stco", 0, struct.pack(">II", 1, chunk_offset)))
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


class Mp4Writer:
    """An mp4 of intra-coded MPEG-4 Part 2 video: what
    ``cv2.VideoWriter(path, fourcc("mp4v"), fps, (W, H))`` records.

    ``size`` is the frames' (height, width); the picture is that size
    cropped to even sizes. ``write`` appends one (H, W, 3) uint8 RGB frame;
    a frame of another size raises ``ValueError`` (cv2 drops it).
    ``release`` writes the index and closes the file; it must be called
    for the file to play."""

    def __init__(self, path: str, fps, size: Tuple[int, int]):
        from ...runtime.loader import load_library
        h, w = (int(v) for v in size)
        self.size = (h, w)
        self.height, self.width = h & ~1, w & ~1
        if not (2 <= self.height <= 8190 and 2 <= self.width <= 8190):
            raise ValueError(f"cannot record {h}x{w} frames (each side "
                             "must lie in [2, 8191])")
        self.resolution, self.increment = time_base(fps)
        self.headers = stream_headers(self.width, self.height,
                                      self.resolution, self.increment)
        load_library()                 # build the packer now, or raise
        self.path = path
        self._sizes: List[int] = []
        self._file = open(path, "wb")
        self._file.write(FTYP + struct.pack(">I4sQ", 1, b"mdat", 0))

    def write(self, frame: np.ndarray):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.shape != self.size + (3,):
            raise ValueError(f"a frame must be {self.size + (3,)} uint8 "
                             f"RGB like the first, not {frame.shape} "
                             f"{frame.dtype}")
        if self._file is None:
            raise ValueError(f"{self.path} was released")
        pic = encode_intra(frame[:self.height, :self.width], QP)
        vop = pack_vop(pic.levels, pic.mb_size, QP, vop_time(
            len(self._sizes), self.resolution, self.increment))
        self._file.write(vop)
        self._sizes.append(len(vop))

    def release(self):
        """Write the ``moov`` index after the samples and close the file
        (again: nothing)."""
        if self._file is None:
            return
        f, self._file = self._file, None
        with f:
            end = f.tell()
            f.seek(len(FTYP) + 8)
            f.write(struct.pack(">Q", end - len(FTYP)))
            f.seek(end)
            f.write(_moov(self.width, self.height, self.resolution,
                          self.increment, self.headers, self._sizes,
                          len(FTYP) + MDAT_HEADER))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


# ---------------------------------------------------------------------------
# reading a file back
# ---------------------------------------------------------------------------
CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"dinf", b"stbl"}


def _boxes(data: bytes, start: int, end: int, path: str,
           out: Dict[str, Tuple[int, int]]):
    while start < end:
        size, kind = struct.unpack_from(">I4s", data, start)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, start + 8)[0], 16
        elif size == 0:
            size = end - start
        if size < head or start + size > end:
            raise ValueError(f"a box {kind!r} of {size} bytes at {start} "
                             f"overruns its parent (ends at {end})")
        name = f"{path}/{kind.decode('latin-1')}".lstrip("/")
        out[name] = (start + head, start + size)
        if kind in CONTAINERS:
            _boxes(data, start + head, start + size, name, out)
        start += size


class Mp4File(NamedTuple):
    boxes: Dict[str, Tuple[int, int]]   # path -> (payload start, end)
    samples: List[bytes]
    sync: List[int]                     # 1-based sample numbers
    decoder_config: bytes               # esds DecoderSpecificInfo
    size: Tuple[int, int]               # the sample entry's (height, width)
    fps: float


def _descriptors(data: bytes):
    """{tag: body} of a run of descriptors, descending into ES (3) and
    DecoderConfig (4)."""
    out, i = {}, 0
    while i < len(data):
        tag, n, i = data[i], 0, i + 1
        while True:
            n, more, i = n << 7 | data[i] & 0x7F, data[i] & 0x80, i + 1
            if not more:
                break
        body, i = data[i:i + n], i + n
        out[tag] = body
        if tag == 3:
            out.update(_descriptors(body[3:]))
        elif tag == 4:
            out.update(_descriptors(body[13:]))
    return out


def read_mp4(path: str) -> Mp4File:
    """The boxes, samples, sync samples, decoder configuration, picture size
    and frame rate of a one-track mp4v file as ``Mp4Writer`` writes it."""
    with open(path, "rb") as f:
        data = f.read()
    boxes: Dict[str, Tuple[int, int]] = {}
    _boxes(data, 0, len(data), "", boxes)
    stbl = "moov/trak/mdia/minf/stbl"

    def words(name, skip=0):
        s, e = boxes[f"{stbl}/{name}"]
        return struct.unpack_from(f">{(e - s) // 4 - skip}I", data,
                                  s + 4 * skip)
    sizes = words("stsz")[3:]
    chunks = words("stco")[2:]
    stsc = words("stsc")[2:]
    if len(chunks) != 1 or stsc[:2] != (1, len(sizes)):
        raise ValueError("read_mp4 reads files whose samples are one chunk")
    samples, at = [], chunks[0]
    for n in sizes:
        samples.append(data[at:at + n])
        at += n
    sync = list(words("stss")[2:])
    entry = boxes[f"{stbl}/stsd"][0] + 8     # after the entry count
    if data[entry + 4:entry + 8] != b"mp4v":
        raise ValueError(f"the sample entry is {data[entry + 4:entry + 8]!r}"
                         ", not mp4v")
    width, height = struct.unpack_from(">HH", data, entry + 32)
    # the VisualSampleEntry's fields take 86 bytes; its boxes follow
    _boxes(data, entry + 86, entry + struct.unpack_from(">I", data,
                                                        entry)[0],
           f"{stbl}/stsd/mp4v", boxes)
    s, e = boxes[f"{stbl}/stsd/mp4v/esds"]
    config = _descriptors(data[s + 4:e]).get(5, b"")
    _, _, count, delta = words("stts")[:4]
    timescale = struct.unpack_from(
        ">I", data, boxes["moov/trak/mdia/mdhd"][0] + 12)[0]
    return Mp4File(boxes, samples, sync, config, (height, width),
                   timescale / delta if count else 0.0)
