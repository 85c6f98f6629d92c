"""The port's rendering tutorials (``tutorials/torch_05``, ``12``) against
the JAX tutorials they port, on the CPU: the same seeded frames, the same
printed lines (shapes equal), and every view saved, every grid composed
and every grid of the stream held at ``tests/test_torch_views.py``'s
tolerances: boxes and flow bit-equal, masks within 1e-6, label and title
text by bounding box (1 px) and IoU (0.9). Each tutorial runs twice, with
text and without (neither package drawing it), which tells the text's
pixels apart. Tutorial 05 records its stream of grids to an mp4: JAX's
``cv2.VideoWriter`` is a stand-in here that keeps the frames it is given,
and the port's clip, written by its own encoder, is read back by cv2."""

import os

import numpy as np
import pytest

from torch_tutorials import (held_printed, held_view, load, record_views,
                             redirect_jax_writes)

# views with a mask are held within 1e-6, the others bit-equal
MASKED = {"05": {"frame.png", "grid.png"},
          "12": {"all.png", "mask_only.png", "composed.png", "grid2x2.png"}}


def run_pair(num, capsys, monkeypatch, root, text):
    jax_name = {"05": "05_rendering", "12": "12_custom_views"}[num]
    with monkeypatch.context() as m:
        recorded = redirect_jax_writes(m, root / f"jax_{text}")
        seen = record_views(m, text)
        load(jax_name).main()
        want = capsys.readouterr().out
        res = load(f"torch_{jax_name}").main(
            "cpu", out_dir=str(root / f"port_{text}"))
        got = capsys.readouterr().out
    return want, got, res, seen, recorded


def held_views(num, on, off):
    assert set(on["port"]) >= set(on["jax"]), (sorted(on["port"]),
                                               sorted(on["jax"]))
    for name in on["jax"]:
        held_view(on["port"][name], off["port"][name], on["jax"][name],
                  off["jax"][name], 1e-6 if name in MASKED[num] else 0.0,
                  tag=name)
    return len(on["jax"])


def test_05_rendering(capsys, monkeypatch, tmp_path):
    cv2 = pytest.importorskip("cv2")
    want, got, res, on, recorded = run_pair("05", capsys, monkeypatch,
                                            tmp_path, True)
    assert held_printed(got, want, skip_port=("recorded:",),
                        skip_jax=("recorded:",)) == 2
    clip = str(tmp_path / "port_True" / "clip.mp4")
    assert res["clip"] == clip
    assert f"recorded: {clip} {os.path.getsize(clip)} bytes" in got
    _, _, _, off, _ = run_pair("05", capsys, monkeypatch, tmp_path, False)
    assert held_views("05", on, off) == 3
    # the stream: 8 grids recorded by each package, the same grids
    assert len(recorded["frames"]) == len(on["jax_grids"]) == 8
    assert len(on["port_grids"]) == 8
    for k in range(8):
        held_view(on["port_grids"][k], off["port_grids"][k],
                  on["jax_grids"][k], off["jax_grids"][k], 1e-6,
                  tag=f"grid {k}")
        # what JAX hands its video writer: the grid as uint8 BGR
        np.testing.assert_array_equal(
            recorded["frames"][k],
            (on["jax_grids"][k][..., ::-1] * 255).astype(np.uint8))
    # the port's clip decodes to JAX's frame count and even-cropped size
    cap = cv2.VideoCapture(clip)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    h, w = (s & ~1 for s in recorded["frames"][0].shape[:2])
    assert len(frames) == len(recorded["frames"])
    assert {f.shape for f in frames} == {(h, w, 3)}


def test_12_custom_views(capsys, monkeypatch, tmp_path):
    want, got, res, on, _ = run_pair("12", capsys, monkeypatch, tmp_path,
                                     True)
    assert held_printed(got, want) == 2
    _, _, _, off, _ = run_pair("12", capsys, monkeypatch, tmp_path, False)
    assert held_views("12", on, off) == 6
    assert res["2x2 grid"] == (276, 320, 3)
    for name in on["jax"]:
        assert (tmp_path / "port_True" / name).stat().st_size > 0
        assert (tmp_path / "jax_True" / "alo_tutorial12" / name
                ).stat().st_size > 0
