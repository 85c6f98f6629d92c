"""The port's mp4 recording against the JAX renderer's cv2 writer on the
CPU, at several quantisers: for each of ``tests/test_torch_video.py``'s
contents, each package's bytes and per-frame PSNR against its source (cv2
decoding both files), and the port's encode time of a 1170x1920 grid of
``utils/tracking_fixture.py``'s scene images (the MOT17 grid's size), its
bytes a frame and its reconstruction's PSNR against it. It
chose ``aloscene/renderer/video.py::QP``: the coarsest quantiser whose
decode is at or above JAX's PSNR on every frame. Needs cv2 and the JAX
package (CPU only).

    JAX_PLATFORMS=cpu python scripts/video_quality.py [QP ...]
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import cv2  # noqa: E402

from aloception_tpu_torch.aloscene.renderer import video  # noqa: E402
from test_torch_video import CONTENTS, decoded, jr, pr  # noqa: E402


def psnrs(path, grids):
    frames, _, _ = decoded(cv2, path)
    h, w = frames[0].shape[:2]
    return [video.psnr(f, (g * 255).astype(np.uint8)[:h, :w])
            for f, g in zip(frames, grids)]


def main(qps):
    chosen = video.QP
    with tempfile.TemporaryDirectory() as d:
        jax = {}
        for name, make in CONTENTS.items():
            path = os.path.join(d, f"{name}_jax.mp4")
            jax[name] = (psnrs(path, make(jr, path)[0]),
                         os.path.getsize(path))
        for qp in qps:
            video.QP = qp
            for name, make in CONTENTS.items():
                path = os.path.join(d, f"{name}_port.mp4")
                got = psnrs(path, make(pr, path)[0])
                want, want_bytes = jax[name]
                worst = min(g - w for g, w in zip(got, want))
                print(f"QP {qp:2d} {name:10s}: port {os.path.getsize(path)} "
                      f"bytes, PSNR {min(got):.2f}-{max(got):.2f} dB; JAX "
                      f"{want_bytes} bytes, {min(want):.2f}-{max(want):.2f}"
                      f" dB; port - JAX per frame >= {worst:+.2f} dB")
    from aloception_tpu_torch.utils.tracking_fixture import scene_image
    rng = np.random.RandomState(0)
    grid = np.concatenate([np.concatenate(
        [scene_image(rng, (585, 960)) for _ in range(2)], 1)
        for _ in range(2)])
    video.QP = chosen
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.mp4")
        w = video.Mp4Writer(path, 30, grid.shape[:2])
        times = []
        for _ in range(4):
            t = time.perf_counter()
            w.write(grid)
            times.append((time.perf_counter() - t) * 1e3)
        w.release()
        nbytes = os.path.getsize(path)
    pic = video.encode_intra(grid)
    luma = video.psnr(pic.y, video.luma_of_rgb(grid))
    rgb = video.psnr(video.rgb_of_ycbcr(pic.y, pic.cb, pic.cr), grid)
    print(f"QP {chosen}: a {grid.shape[0]}x{grid.shape[1]} grid of scene "
          f"images: Mp4Writer.write {', '.join(f'{t:.1f}' for t in times)} "
          f"ms on the CPU, {nbytes / 4 / 1e6:.4f} MB a frame, the "
          f"reconstruction's PSNR luma {luma:.2f} dB, RGB {rgb:.2f} dB")

if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5, 6])
