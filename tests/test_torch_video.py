"""The port's mp4 recording (``aloscene/renderer/video.py`` behind
``Renderer.render(record_file=)``) against the JAX renderer's
``cv2.VideoWriter(*"mp4v")``, on the CPU. cv2 (FFmpeg) is the independent
decoder: each package records the same grids, both files are read back,
and the port's must match JAX's in frame count, even-cropped size, fps and
FOURCC, decode per frame within 0.5 dB of JAX's PSNR against the source
(or above it), and decode over luma at 40 dB or more against the encoder's
own reconstruction (the decode taken back to Y' by the same BT.601, so that
chroma upsampling, which FFmpeg and the port do differently, does not
count). The native packer is held to the plain Python one byte for byte,
and every code of the intra TCOEF table and each escape is decoded by
FFmpeg from a picture built to hold them."""

import os

import numpy as np
import pytest

from aloception_tpu.aloscene.renderer import renderer as jr
from aloception_tpu_torch.aloscene.renderer import renderer as pr
from aloception_tpu_torch.aloscene.renderer import draw, video
from aloception_tpu_torch.aloscene.renderer.text import put_text
from torch_tutorials import load

LUMA_DB = 40.0          # the decode against the port's reconstruction
JAX_MARGIN_DB = 0.5     # the port's PSNR against the source, below JAX's


# ----------------------------------------------------------------------
# the contents: each records its grids through one package's renderer
# ----------------------------------------------------------------------
def tutorial_clip(mod, path):
    """Tutorial 05's stream: 8 frames of ``make_frame`` at fps 4."""
    rng = np.random.RandomState(0)
    if mod is jr:
        frames = [load("05_rendering").make_frame(rng, t) for t in range(8)]
    else:
        frames = [load("torch_05_rendering").make_frame(rng, "cpu", t)
                  for t in range(8)]
    r = mod.Renderer()
    grids = [r.render([f.get_view()], renderer="record", record_file=path,
                      fps=4) for f in frames]
    assert r.save() == path
    return grids, 4


def labelled_gradient(t):
    """A 480x640 colour gradient with a 2-px box and a label drawn by the
    port's ``draw``/``text``, shifted by ``t``."""
    ys, xs = np.mgrid[0:480, 0:640]
    img = np.stack([xs * 255 / 640, ys * 255 / 480, 255 - xs * 200 / 640],
                   -1).astype(np.uint8)
    draw.rectangle(img, (100 + 10 * t, 120), (300 + 10 * t, 360),
                   (255, 0, 0), 2)
    put_text(img, "person 0.87", (100 + 10 * t, 110), 0.64, (255, 255, 0),
             1)
    return img


def gradient_clip(mod, path):
    r = mod.Renderer()
    grids = [r.render([mod.View(labelled_gradient(t))], record_file=path,
                      fps=4) for t in range(4)]
    assert r.save() == path
    return grids, 4


def odd_clip(mod, path):
    """A 37x33 grid (a 19x33 view under its 18-row banner) of random
    pixels, 3 calls of the module-level ``render`` at fps 5."""
    rng = np.random.RandomState(3)
    grids = [mod.render([mod.View(rng.rand(19, 33, 3))], renderer="record",
                        record_file=path, fps=5) for _ in range(3)]
    assert grids[0].shape == (37, 33, 3)
    assert mod.render_save() == path
    return grids, 5


CONTENTS = {"tutorial05": tutorial_clip, "gradient": gradient_clip,
            "odd37x33": odd_clip}


def decoded(cv2, path):
    """(the frames as RGB, fps, FOURCC) of ``path`` read by cv2."""
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    fps, fourcc = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FOURCC))
    cap.release()
    return frames, fps, fourcc


@pytest.mark.parametrize("content", sorted(CONTENTS))
def test_recording_matches_jax(content, tmp_path):
    cv2 = pytest.importorskip("cv2")
    got_path, want_path = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    grids, fps = CONTENTS[content](pr, got_path)
    want_grids, _ = CONTENTS[content](jr, want_path)
    got, got_fps, got_cc = decoded(cv2, got_path)
    want, want_fps, want_cc = decoded(cv2, want_path)
    h, w = (s & ~1 for s in grids[0].shape[:2])
    assert len(got) == len(want) == len(grids)
    assert got_fps == want_fps == fps and got_cc == want_cc
    assert got[0].shape == want[0].shape == (h, w, 3)
    for k, (g, jg) in enumerate(zip(grids, want_grids)):
        src = (g * 255).astype(np.uint8)[:h, :w]
        jsrc = (jg * 255).astype(np.uint8)[:h, :w]
        mine, theirs = video.psnr(got[k], src), video.psnr(want[k], jsrc)
        assert mine >= theirs - JAX_MARGIN_DB, (k, mine, theirs)
        pic = video.encode_intra(src, video.QP)
        luma = video.psnr(video.luma_of_rgb(got[k]), pic.y)
        assert luma >= LUMA_DB, (k, luma)


# ----------------------------------------------------------------------
# the packer, the container, the API
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hw,qp,time", [
    ((48, 64), 3, video.VopTime(0, 0, 2)),
    ((37, 33), 3, video.VopTime(1, 29, 5)),
    ((64, 80), 12, video.VopTime(2, 1, 1))])
def test_native_packer_matches_python(hw, qp, time):
    """The C++ packer's VOP bytes equal the plain Python encoder's; the
    odd-sized frame is cropped to even sizes first, as the writer does."""
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    img[: hw[0] // 2] //= 8                     # flat and busy regions
    pic = video.encode_intra(img[:hw[0] & ~1, :hw[1] & ~1], qp)
    got = video.pack_vop(pic.levels, pic.mb_size, qp, time)
    assert got == video.pack_vop_python(pic.levels, pic.mb_size, qp, time)
    assert got[:4] == b"\x00\x00\x01\xb6"


def test_box_tree(tmp_path):
    """``ftyp``, ``mdat``, ``moov`` in that order; one sample a frame, each
    the VOP the packer makes of the frame, every one a sync sample; the
    ``esds`` carries the stream headers with the VOL start code."""
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (40, 58, 3)).astype(np.uint8)
              for _ in range(3)]
    path = str(tmp_path / "a.mp4")
    with video.Mp4Writer(path, 25, (40, 58)) as w:
        for f in frames:
            w.write(f)
    mp4 = video.read_mp4(path)
    assert [k for k in mp4.boxes if "/" not in k] == ["ftyp", "mdat", "moov"]
    stbl = "moov/trak/mdia/minf/stbl"
    for box in ("stsd", "stts", "stss", "stsc", "stsz", "stco"):
        assert f"{stbl}/{box}" in mp4.boxes
    assert mp4.sync == [1, 2, 3] and len(mp4.samples) == 3
    assert (mp4.size, mp4.fps) == ((40, 58), 25.0)
    assert b"\x00\x00\x01\x20" in mp4.decoder_config
    assert mp4.decoder_config == video.stream_headers(58, 40, 25, 1)
    for k, f in enumerate(frames):
        pic = video.encode_intra(f, video.QP)
        assert mp4.samples[k] == video.pack_vop(
            pic.levels, pic.mb_size, video.QP, video.vop_time(k, 25, 1))
    # a whole second passes between frames 29 and 30 at 30 fps
    assert video.vop_time(30, 30, 1) == (1, 0, 5)
    assert video.vop_time(31, 30, 1) == (0, 1, 5)


def test_frame_of_another_size_raises(tmp_path):
    """cv2 drops a frame whose size differs from the first; the port
    raises, from the writer and from the renderer."""
    w = video.Mp4Writer(str(tmp_path / "a.mp4"), 5, (32, 48))
    w.write(np.zeros((32, 48, 3), np.uint8))
    with pytest.raises(ValueError, match="like the first"):
        w.write(np.zeros((32, 50, 3), np.uint8))
    w.release()
    r = pr.Renderer()
    path = str(tmp_path / "b.mp4")
    r.render([pr.View(np.zeros((20, 30, 3)))], record_file=path)
    with pytest.raises(ValueError, match="like the first"):
        r.render([pr.View(np.zeros((22, 30, 3)))], record_file=path)
    assert r.save() == path and len(video.read_mp4(path).samples) == 1


def test_module_render_appends_to_one_file(tmp_path):
    """Three module-level ``render`` calls append to one file, which
    ``render_save`` finalizes and names; a recording after ``save``
    starts a new file."""
    path = str(tmp_path / "rec.mp4")
    for _ in range(3):
        pr.render([pr.View(np.random.rand(32, 32, 3))], renderer="record",
                  record_file=path, fps=5)
    assert pr.render_save() == path
    mp4 = video.read_mp4(path)
    assert len(mp4.samples) == 3 and mp4.sync == [1, 2, 3]
    r = pr.Renderer()
    r.render([pr.View(np.zeros((20, 30, 3)))], record_file=path)
    assert r.save() == path and r.save() == path
    second = str(tmp_path / "second.mp4")
    r.render([pr.View(np.zeros((20, 30, 3)))], record_file=second)
    assert r.save() == second
    assert len(video.read_mp4(second).samples) == 1


@pytest.mark.parametrize("table", ["MCBPC_INTRA", "CBPY",
                                   "DC_SIZE_LUMINANCE", "DC_SIZE_CHROMINANCE",
                                   "INTRA_TCOEF"])
def test_tables_are_prefix_free(table):
    """No code of a table is the start of another; the intra TCOEF codes
    with their sign bit and the escape leave unused only the paths that
    start with nine zeros (Kraft sum 1 - 2**-9), which guard the start
    codes."""
    codes = getattr(video, table)
    if table == "INTRA_TCOEF":
        codes = [c for cs in codes.values() for c in cs] + [video.ESCAPE]
    assert len(set(codes)) == len(codes)
    for a in codes:
        assert not [b for b in codes if b != a and b.startswith(a)], a
    if table == "INTRA_TCOEF":
        # a code and its sign bit: two paths of len + 1 bits
        assert sum(2.0 ** -len(c) for c in codes) == 1 - 2.0 ** -9


def events_picture(qp):
    """Levels holding every (last, run, level) of the intra TCOEF table
    once, with a sign that alternates, and events that need each escape;
    one event list a luma block, mid-grey DCs, neutral chroma."""
    events = []
    for (last, run), codes in video.INTRA_TCOEF.items():
        for level in range(1, len(codes) + 1):
            events.append([(run, level)] + ([] if last else [(0, 1)]))
    events += [[(0, 30), (0, 1)],            # escape 1: level - LMAX
               [(15, 1), (0, 1)],            # escape 2: run - RMAX - 1
               [(21, 1)],                    # escape 2 on a last event
               [(14, 5), (0, 1)],            # escape 3
               [(25, 2)]]                    # escape 3 on a last event
    n_mb = -(-len(events) // 4)
    mb_w = 4
    mb_h = -(-n_mb // mb_w)
    levels = np.zeros((mb_h * mb_w, 6, 64), np.int16)
    levels[..., 0] = 1024 // video.dc_scaler(qp, True)
    levels[..., 4:, 0] = 1024 // video.dc_scaler(qp, False)
    sign = 1
    for k, block in enumerate(events):
        pos = 0
        for run, level in block:
            pos += run + 1
            levels[k // 4, k % 4, pos] = sign * level
            sign = -sign
    return levels, (mb_h, mb_w)


def test_every_code_decodes(tmp_path, monkeypatch):
    """Each code of the table and each escape, as FFmpeg decodes them:
    every luma block's decode within 1.0 RMS of the reconstruction, less
    the decode's constant offset (FFmpeg's YUV -> RGB sits about one level
    below BT.601's). At QP 8 a code of the wrong level moves its block by
    2 RMS or more (16 in a coefficient), one of the wrong run or sign by
    more, and one of the wrong length every block after it."""
    cv2 = pytest.importorskip("cv2")
    qp = 8
    levels, (mh, mw) = events_picture(qp)
    rec = video.reconstruct(levels, (mh, mw), qp, (mh * 16, mw * 16))
    monkeypatch.setattr(video, "QP", qp)
    monkeypatch.setattr(video, "encode_intra", lambda rgb, q: video.
                        IntraPicture(levels, (mh, mw), *rec))
    path = str(tmp_path / "codes.mp4")
    with video.Mp4Writer(path, 1, (mh * 16, mw * 16)) as w:
        w.write(np.zeros((mh * 16, mw * 16, 3), np.uint8))
    frames, _, _ = decoded(cv2, path)
    assert len(frames) == 1
    err = video.luma_of_rgb(frames[0]) - rec[0]
    assert abs(err.mean()) < 2
    err -= err.mean()
    rms = np.sqrt((err.reshape(2 * mh, 8, 2 * mw, 8) ** 2).mean((1, 3)))
    assert rms.max() <= 1.0, np.argwhere(rms > 1.0)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: with the packer's library missing and its build
    failing, opening a recording raises with the compiler's exit."""
    from aloception_tpu_torch.export import base_exporter
    from aloception_tpu_torch.runtime import loader
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(loader, "library_path",
                        lambda: tmp_path / "_build" / "libaloloader_x.so")
    monkeypatch.setattr(base_exporter, "host_compiler", lambda: "false")
    loader.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building aloloader.cpp"):
            video.Mp4Writer(str(tmp_path / "a.mp4"), 5, (16, 16))
    finally:
        loader.load_library.cache_clear()
    assert not os.path.exists(tmp_path / "a.mp4")
