"""Text as OpenCV 5 draws it for ``cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, scale, color, thickness, LINE_AA)``, on (H, W, C)
uint8 numpy images on the host.

OpenCV 5 renders that call with its built-in TrueType face (Rubik, a
variable font), not with Hershey strokes: ``round(27 * scale)`` pixels
from the baseline to the ascender, weight 400 for a thickness of 1 and 600
above, glyphs at integer pen positions that advance by the whole pixels of each
glyph's scaled advance (rounded to 1/64 first), the baseline at ``org``'s
y, every pixel blended
with the colour by its anti-aliased coverage (the same for LINE_8). The
outlines of printable ASCII at both weights are carried in ``glyphs.npz``
(written by ``scripts/make_text_glyphs.py``; Rubik: Copyright 2015 The
Rubik Project Authors, SIL Open Font License 1.1, its notice kept in the
table); other characters draw as "?". A glyph is flattened as
stb_truetype flattens quadratics (0.35 px) and its exact area coverage
accumulated per pixel; the coverage of a glyph at a size is computed once.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import List, Tuple

import numpy as np

_TABLE = Path(__file__).resolve().with_name("glyphs.npz")
FLATNESS = 0.35    # pixels
SIZE_PER_SCALE = 27


@functools.lru_cache(maxsize=None)
def _table():
    with np.load(_TABLE) as d:
        return {k: d[k] for k in d.files}


def font_params(scale: float, thickness: int) -> Tuple[int, int]:
    """(pixel size, weight) of OpenCV 5's FONT_HERSHEY_SIMPLEX at ``scale``
    and ``thickness``."""
    return int(math.floor(scale * SIZE_PER_SCALE + 0.5)), \
        400 if thickness <= 1 else 600


def _tesselate(pts: List, x0, y0, x1, y1, x2, y2, tol2: float, n: int):
    """stb_truetype's recursive subdivision of a quadratic."""
    mx, my = (x0 + 2 * x1 + x2) / 4, (y0 + 2 * y1 + y2) / 4
    dx, dy = (x0 + x2) / 2 - mx, (y0 + y2) / 2 - my
    if n > 16:
        return
    if dx * dx + dy * dy > tol2:
        _tesselate(pts, x0, y0, (x0 + x1) / 2, (y0 + y1) / 2, mx, my, tol2,
                   n + 1)
        _tesselate(pts, mx, my, (x1 + x2) / 2, (y1 + y2) / 2, x2, y2, tol2,
                   n + 1)
    else:
        pts.append((x2, y2))


def _contours(rows: np.ndarray, s: float) -> List[List[Tuple[float, float]]]:
    tol = FLATNESS / s
    polys, cur = [], None
    for kind, x1, y1, x2, y2 in rows.astype(np.float64).tolist():
        if kind == 0:
            cur = [(x2, y2)]
            polys.append(cur)
        elif kind == 1:
            cur.append((x2, y2))
        else:
            px, py = cur[-1]
            _tesselate(cur, px, py, x1, y1, x2, y2, tol * tol, 0)
    return [[(x * s, -y * s) for x, y in p] for p in polys]


def _accumulate(area, cover, x0, y0, x1, y1):
    """Exact signed area coverage of the segment, split at every pixel row
    and column it crosses: its area right of it within its cell goes to
    ``area``, its full height to ``cover`` one cell to its right."""
    if y0 == y1:
        return
    lo, hi = min(y0, y1), max(y0, y1)
    cuts = list(range(int(math.floor(lo)) + 1, int(math.ceil(hi))))
    if y1 < y0:
        cuts.reverse()
    pts = [(x0, y0)] + [(x0 + (c - y0) * (x1 - x0) / (y1 - y0), c)
                        for c in cuts] + [(x1, y1)]
    for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
        row = int(math.floor(min(ay, by)))
        lo, hi = min(ax, bx), max(ax, bx)
        xc = list(range(int(math.floor(lo)) + 1, int(math.ceil(hi))))
        if bx < ax:
            xc.reverse()
        pp = [(ax, ay)] + [(c, ay + (c - ax) * (by - ay) / (bx - ax))
                           for c in xc] + [(bx, by)]
        for (px, py), (qx, qy) in zip(pp[:-1], pp[1:]):
            col = int(math.floor(min(px, qx)))
            dy = qy - py
            area[row, col] += dy * (1 - ((px + qx) / 2 - col))
            cover[row, col + 1] += dy


@functools.lru_cache(maxsize=4096)
def glyph_coverage(char: str, size: int, weight: int):
    """(top, left, coverage) of ``char`` with its pen at (0, 0) and its
    baseline at y = 0: the float coverage (0..1, or more where contours
    overlap) of the pixels from row ``top`` and column ``left`` on, or None
    for a glyph without an outline."""
    t = _table()
    code = ord(char) - int(t["first_char"])
    if not 0 <= code < t["advances"].shape[1]:
        code = ord("?") - int(t["first_char"])
    w = int(np.nonzero(t["weights"] == weight)[0][0])
    rows = t["segs"][t["offsets"][w, code]:t["offsets"][w, code + 1]]
    if not len(rows):
        return None
    s = size / float(t["ascender"])
    polys = _contours(rows, s)
    xs = [x for p in polys for x, _ in p]
    ys = [y for p in polys for _, y in p]
    left, top = int(math.floor(min(xs))), int(math.floor(min(ys)))
    W = int(math.ceil(max(xs))) - left + 1
    H = int(math.ceil(max(ys))) - top + 1
    area = np.zeros((H, W + 2))
    cover = np.zeros((H, W + 2))
    for p in polys:
        q = [(x - left, y - top) for x, y in p]
        for a, b in zip(q, q[1:] + q[:1]):
            _accumulate(area, cover, a[0], a[1], b[0], b[1])
    cov = np.abs(area + np.cumsum(cover, 1))[:, :W]
    return top, left, cov


def advance(char: str, size: int, weight: int) -> int:
    t = _table()
    code = ord(char) - int(t["first_char"])
    if not 0 <= code < t["advances"].shape[1]:
        code = ord("?") - int(t["first_char"])
    w = int(np.nonzero(t["weights"] == weight)[0][0])
    px = float(t["advances"][w, code]) * size / float(t["ascender"])
    return int(math.floor(math.floor(px * 64 + 0.5) / 64))


def put_text(img: np.ndarray, text: str, org, scale: float, color,
             thickness: int) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, LINE_AA)`` in place on an (H, W, C) uint8 image."""
    size, weight = font_params(scale, thickness)
    H, W = img.shape[:2]
    pen, base = int(org[0]), int(org[1])
    placed = []
    for ch in str(text):
        g = glyph_coverage(ch, size, weight)
        if g is not None:
            top, left, c = g
            y0, x0 = base + top, pen + left
            ys, xs = max(y0, 0), max(x0, 0)
            ye, xe = min(y0 + c.shape[0], H), min(x0 + c.shape[1], W)
            if ys < ye and xs < xe:
                placed.append((ys, ye, xs, xe,
                               c[ys - y0:ye - y0, xs - x0:xe - x0]))
        pen += advance(ch, size, weight)
    if not placed:
        return img
    # blend over the box the glyphs touch only
    Y0, Y1 = min(p[0] for p in placed), max(p[1] for p in placed)
    X0, X1 = min(p[2] for p in placed), max(p[3] for p in placed)
    cov = np.zeros((Y1 - Y0, X1 - X0))
    for ys, ye, xs, xe, c in placed:
        cov[ys - Y0:ye - Y0, xs - X0:xe - X0] += c
    a = (np.minimum(np.floor(cov * 255 + 0.5), 255) / 255.0)[..., None]
    vals = np.clip(np.rint(np.asarray(color, np.float64)), 0, 255)
    col = np.zeros(img.shape[2])
    col[:min(len(vals), len(col))] = vals[:len(col)]
    roi = img[Y0:Y1, X0:X1]
    roi[:] = np.floor(roi * (1 - a) + col * a + 0.5).astype(np.uint8)
    return img
