"""Tutorial 5 (PyTorch port) — rendering: Views, grid compositing, and label
overlays. The port of ``05_rendering.py`` (compare the reference's
tutorials/4.0-rendering.py … 4.3-get_view_flow.py).

Every aloscene type knows how to draw itself: frame.get_view() recursively
composites the frame and all attached labels (boxes, masks, flow as a color
wheel, depth as a colormap). Views combine into grids, save as PNGs and
record straight to mp4 (the port's own MPEG-4 Part 2 encoder,
``aloscene/renderer/video.py``, where the JAX renderer uses OpenCV's).

Runs on the CUDA card; ``main("cpu")`` (or ``--cpu``) runs it on the CPU.

Run: python tutorials/torch_05_rendering.py [--cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def make_frame(rng, device, t=0.0):
    import torch

    from aloception_tpu_torch.aloscene import (BoundingBoxes2D, Frame,
                                               Labels, Mask)

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    frame = Frame(on(rng.uniform(0, 255, (3, 120, 160))))
    frame.append_boxes2d(BoundingBoxes2D(
        on([[0.3 + 0.05 * t, 0.4, 0.25, 0.3]]),
        boxes_format="xcyc", absolute=False,
        labels=Labels(on([0.0]), labels_names=("player",))))
    m = np.zeros((1, 120, 160), np.float32)
    m[0, 60:100, 20:80] = 1.0
    frame.append_segmentation(Mask(on(m), labels=Labels(on([1.0]))))
    return frame


def main(device=None, out_dir=None):
    """Returns what it printed, as data: the views' shapes and the paths
    written."""
    import torch

    from aloception_tpu_torch.aloscene import Flow
    from aloception_tpu_torch.aloscene.renderer import Renderer, View
    from aloception_tpu_torch.models.transformers import entry_device

    device = entry_device(device)
    out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                      "alo_tutorial05")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    out = {}

    # --- a single view: frame + recursive label overlays ------------------
    frame = make_frame(rng, device)
    view = frame.get_view()            # boxes + mask drawn automatically
    out["frame"] = view.save(os.path.join(out_dir, "frame.png"))
    out["frame view"] = view.image.shape
    print("frame view:", view.image.shape, "->", out["frame"])

    # --- label types render standalone too --------------------------------
    flow = Flow(torch.from_numpy(np.stack(np.meshgrid(
        np.linspace(-1, 1, 160), np.linspace(-1, 1, 120))).astype(
            np.float32)).to(device))
    flow_view = flow.get_view()        # Middlebury color wheel
    out["flow"] = flow_view.save(os.path.join(out_dir, "flow.png"))

    # --- grids: compose views side by side ---------------------------------
    grid = Renderer.get_grid_view([frame.get_view(), flow_view,
                                   frame.hflip().get_view()])
    out["grid"] = View(grid).save(os.path.join(out_dir, "grid.png"))
    out["grid shape"] = grid.shape
    print("grid:", grid.shape)

    # --- streaming/recording: Renderer.render(..., record_file=...) --------
    r = Renderer()
    mp4 = os.path.join(out_dir, "clip.mp4")
    for t in range(8):                  # 8 synthetic 'video' frames
        r.render([make_frame(rng, device, t).get_view()], renderer="record",
                 record_file=mp4, fps=4)
    out["clip"] = r.save()
    out["clip bytes"] = os.path.getsize(mp4)
    print("recorded:", mp4, out["clip bytes"], "bytes")
    return out


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv else None)
