"""Write ``aloception_tpu_torch/aloscene/renderer/glyphs.npz``: the outlines
of the printable ASCII characters of the font OpenCV 5 draws
``FONT_HERSHEY_SIMPLEX`` with, at the two weights its ``putText`` uses.

OpenCV 5's ``putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
thickness)`` draws no Hershey strokes: it renders its built-in "sans" face,
Rubik (a variable TrueType font under the SIL Open Font License 1.1,
embedded gzip-compressed in the OpenCV library), at ``round(27 * scale)``
pixels of ascender and weight 400 for a thickness of 1, 600 above. The port
has no OpenCV, so this script takes the font out of the installed ``cv2``
module, instances it at both weights with fontTools (``avar`` mapping and
``gvar`` deltas applied, coordinates kept as floats) and stores each glyph
as rows ``[kind, x1, y1, x2, y2]`` in whole font units (kind 0 starts a
contour at (x2, y2), 1 is a line to (x2, y2), 2 a quadratic with control
(x1, y1) to (x2, y2); TrueType's implied on-curve points made explicit),
and each glyph's advance (the default instance's for glyphs without an
outline, as OpenCV takes it). The rounding to whole units and the layout
rules of ``text.py`` were found by comparing with cv2.putText. ``aloscene/renderer/text.py`` rasterises them.

Needs cv2 and fontTools (not the card machine). Run:
    python scripts/make_text_glyphs.py
"""

from __future__ import annotations

import io
import re
import zlib
from pathlib import Path

import numpy as np

OUT = (Path(__file__).resolve().parents[1] / "aloception_tpu_torch" /
       "aloscene" / "renderer" / "glyphs.npz")
WEIGHTS = (400, 600)
CHARS = [chr(c) for c in range(32, 127)]


def rubik_from_cv2() -> bytes:
    """The gzip member named Rubik.ttf inside the cv2 extension module."""
    import cv2
    lib = next(Path(cv2.__file__).parent.glob("cv2*.so"))
    data = lib.read_bytes()
    m = re.search(rb"\x1f\x8b\x08\x08.{6}Rubik\.ttf\x00", data, re.S)
    if m is None:
        raise RuntimeError(f"no Rubik.ttf in {lib}")
    return zlib.decompressobj(31).decompress(data[m.start():])


def glyph_rows(glyph) -> np.ndarray:
    """OpenCV keeps a varied glyph's points in whole font units (each
    coordinate floored) and makes an implied on-curve point as
    stb_truetype does, ``(a + b) >> 1`` of the integers."""
    from fontTools.pens.recordingPen import RecordingPen
    pen = RecordingPen()
    glyph.draw(pen)

    def whole(p):
        return (int(np.floor(p[0])), int(np.floor(p[1])))
    rows = []
    for op, args in pen.value:
        if op == "moveTo":
            rows.append((0, 0, 0, *whole(args[0])))
        elif op == "lineTo":
            rows.append((1, 0, 0, *whole(args[0])))
        elif op == "qCurveTo":
            *offs, end = args
            if end is None:
                raise ValueError("a contour without on-curve points")
            offs = [whole(c) for c in offs]
            for i, c in enumerate(offs):
                e = whole(end) if i == len(offs) - 1 else (
                    (c[0] + offs[i + 1][0]) >> 1, (c[1] + offs[i + 1][1]) >> 1)
                rows.append((2, *c, *e))
        elif op in ("closePath", "endPath"):
            continue
        else:
            raise ValueError(f"unexpected outline operation {op}")
    return np.asarray(rows, np.float64).reshape(-1, 5)


def main():
    from fontTools.ttLib import TTFont
    font = TTFont(io.BytesIO(rubik_from_cv2()))
    cmap = font.getBestCmap()
    default = font.getGlyphSet()
    segs, offsets, advances = [], [], []
    n = 0
    for w in WEIGHTS:
        gs = font.getGlyphSet(location={"wght": w})
        offs, adv = [], []
        for ch in CHARS:
            name = cmap[ord(ch)]
            rows = glyph_rows(gs[name])
            offs.append(n)
            segs.append(rows)
            n += len(rows)
            # OpenCV's advances are whole font units too (floored; the
            # rounding to 1/100 undoes fontTools' float error at integers)
            adv.append(np.floor(round(gs[name].width, 2)) if len(rows)
                       else default[name].width)
        offs.append(n)
        offsets.append(offs)
        advances.append(adv)
    name = font["name"]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT, segs=np.concatenate(segs).astype(np.float32),
        offsets=np.asarray(offsets, np.int32),
        advances=np.asarray(advances, np.float32),
        weights=np.asarray(WEIGHTS, np.int32),
        first_char=np.int32(32),
        ascender=np.int32(font["hhea"].ascent),
        notice=np.asarray(name.getName(0, 3, 1, 0x409).toUnicode() + ". " +
                          name.getName(13, 3, 1, 0x409).toUnicode()))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {n} rows)")


if __name__ == "__main__":
    main()
