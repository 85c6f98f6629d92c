"""Views and the renderer (counterpart of
``aloception_tpu/aloscene/renderer/renderer.py``; reference:
aloscene/renderer/renderer.py:91 View, :172 Renderer).

A ``View`` is a float32 HWC image in [0, 1] and a title; the ``Renderer``
composites views into a grid. The port draws without OpenCV: grids resize
their cells with the aloscene bilinear resize (cv2's INTER_LINEAR of float
images: half-pixel centres, no antialiasing), titles and labels are drawn
by ``text.put_text`` (what OpenCV 5's ``putText`` draws), ``View.save``
writes a PNG with Pillow (the pixels ``cv2.imwrite`` stores) and
``method="matplotlib"`` shows a view through matplotlib where it is
installed. ``Renderer.render(..., record_file=, fps=)`` appends each grid to
an mp4 as the JAX renderer's ``cv2.VideoWriter(*"mp4v")`` does, through the
port's own MPEG-4 Part 2 intra encoder (``video.Mp4Writer``: the frame
``(grid * 255)`` truncated to uint8, cropped to even sizes; a grid of
another size than the first raises ``ValueError`` where cv2 drops it), and
``save()`` finalizes it. The display window (``cv2.imshow``) needs a GUI
toolkit and is refused with the reason.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..spatial import resize_bilinear
from .text import put_text
from .video import Mp4Writer

NO_WINDOW = ("the PyTorch port has no display window (the JAX renderer "
             "shows views with cv2.imshow); save a view with View.save or "
             "use method='matplotlib'")


def put_adaptive_cv2_text(frame: np.ndarray, text: str, x: int, y: int,
                          color=(0, 1.0, 0)):
    """Text scaled to the frame size (renderer.py:24): scale max(0.4,
    max(H, W) / 1000), thickness max(int(2 * scale), 1), origin
    (int(x), int(y)). Accepts float [0, 1] or uint8 frames; draws in place
    when uint8, otherwise round-trips through uint8 (truncated) as the JAX
    function does. A float colour component <= 1 counts in [0, 1]."""
    scale = max(frame.shape[0], frame.shape[1]) / 1000.0
    scale = max(scale, 0.4)
    is_float = frame.dtype != np.uint8
    img = (np.clip(frame, 0, 1) * 255).astype(np.uint8) if is_float \
        else frame
    c = tuple(int(v * 255) if isinstance(v, float) and v <= 1 else int(v)
              for v in color)
    put_text(img, str(text), (int(x), int(y)), scale, c,
             max(int(2 * scale), 1))
    if is_float:
        frame[:] = img.astype(np.float32) / 255.0
    return frame


def resize_view(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` of a float32 HWC image
    (``spatial.resize_bilinear``)."""
    h, w = int(size[0]), int(size[1])
    if img.shape[:2] == (h, w):
        return img.copy()
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    out = resize_bilinear(t.permute(2, 0, 1)[None], (h, w))
    return out[0].permute(1, 2, 0).numpy()


class View:
    """(renderer.py:91)"""

    CV = "cv"
    MATPLOTLIB = "matplotlib"

    def __init__(self, image: np.ndarray, title: Optional[str] = None):
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, -1)
        if image.max() > 1.5:
            image = image / 255.0
        self.image = np.clip(image, 0, 1)
        self.title = title

    def add(self, view: "View") -> "View":
        """Horizontal concat of two views, padded to the tallest."""
        h = max(self.image.shape[0], view.image.shape[0])

        def padded(img):
            return np.pad(img, ((0, h - img.shape[0]), (0, 0), (0, 0)))
        self.image = np.concatenate([padded(self.image), padded(view.image)],
                                    1)
        return self

    def render(self, method: str = CV, location: Optional[str] = None,
               figsize=(10, 10)):
        if location is not None:
            return self.save(location)
        if method != self.MATPLOTLIB:
            raise RuntimeError(NO_WINDOW)
        plt = _pyplot()
        plt.figure(figsize=figsize)
        plt.imshow(self.image)
        if self.title:
            plt.title(self.title)
        plt.axis("off")
        plt.show()

    def save(self, location: str) -> str:
        """Write the view as ``cv2.imwrite`` does: ``(image * 255)``
        truncated to uint8; a location without an extension gets ".png"."""
        img = (self.image * 255).astype(np.uint8)
        if not os.path.splitext(location)[1]:
            location += ".png"
        Image.fromarray(img).save(location)
        return location


def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("method='matplotlib' needs matplotlib, which is "
                           f"not installed: {e}") from e
    return plt


class Renderer:
    """(renderer.py:172) grid compositing and the mp4 recording; the
    display window is refused (``NO_WINDOW``)."""

    def __init__(self):
        self._writer: Optional[Mp4Writer] = None
        self._path: Optional[str] = None

    @staticmethod
    def _title_banner(img: np.ndarray, title: str) -> np.ndarray:
        """Dark banner strip above a cell carrying its title (reference
        add_title, renderer.py:251)."""
        bh = max(18, img.shape[0] // 12)
        banner = np.full((bh, img.shape[1], 3), 0.15, np.float32)
        put_adaptive_cv2_text(banner, title, 8, int(bh * 0.75),
                              color=(1.0, 1.0, 1.0))
        return np.concatenate([banner, img], axis=0)

    @staticmethod
    def get_grid_view(views: Sequence[View], cell_grid_size=None,
                      grid_size=None, add_title: bool = True) -> np.ndarray:
        """Composite views into a square-ish grid (renderer.py:203)."""
        views = list(views)
        n = len(views)
        if n == 0:
            raise ValueError("a grid needs at least one view")
        cols = grid_size or math.ceil(math.sqrt(n))
        rows = math.ceil(n / cols)
        if cell_grid_size is None:
            cell_grid_size = views[0].image.shape[:2]
        ch, cw = cell_grid_size
        bh = max(18, ch // 12) if add_title else 0
        grid = np.zeros((rows * (ch + bh), cols * cw, 3), np.float32)
        for i, v in enumerate(views):
            r, c = divmod(i, cols)
            img = resize_view(v.image, (ch, cw))
            if add_title:
                img = Renderer._title_banner(img, v.title or "")
            grid[r * (ch + bh):(r + 1) * (ch + bh),
                 c * cw:(c + 1) * cw] = img
        return grid

    @classmethod
    def get_user_defined_grid_view(cls, views, add_title: bool = True
                                   ) -> np.ndarray:
        """Composite a nested list of views (rows of View) into exactly that
        layout (renderer.py:278); cells take the first view's size, short
        rows are padded with black cells."""
        rows = [list(r) for r in views]
        ch, cw = rows[0][0].image.shape[:2]
        bh = max(18, ch // 12) if add_title else 0
        ncols = max(len(r) for r in rows)
        grid = np.zeros((len(rows) * (ch + bh), ncols * cw, 3), np.float32)
        for r, row in enumerate(rows):
            for c, v in enumerate(row):
                img = resize_view(v.image, (ch, cw))
                if add_title:
                    img = cls._title_banner(img, v.title or "")
                grid[r * (ch + bh):(r + 1) * (ch + bh),
                     c * cw:(c + 1) * cw] = img
        return grid

    def render(self, views: Sequence[View], renderer: str = "cv",
               cell_grid_size=None, record_file: Optional[str] = None,
               fps: int = 30, grid_size=None, skip_views: bool = False,
               add_title: bool = True) -> np.ndarray:
        """(renderer.py:311) the grid of ``views`` (a flat list, or a
        nested list of rows), appended to the mp4 ``record_file`` at ``fps``
        when one is given (the first call opens it at this grid's size and
        ``fps``; later calls append, whatever they name), else shown (only
        ``renderer="matplotlib"``: the window raises) unless
        ``skip_views``."""
        if views and isinstance(views[0], (list, tuple)):
            grid = self.get_user_defined_grid_view(views, add_title)
        else:
            grid = self.get_grid_view(views, cell_grid_size, grid_size,
                                      add_title)
        if record_file is not None:
            if self._writer is None:
                self._writer = Mp4Writer(record_file, fps, grid.shape[:2])
                self._path = record_file
            self._writer.write((grid * 255).astype(np.uint8))
        elif not skip_views:
            if renderer != View.MATPLOTLIB:
                raise RuntimeError(NO_WINDOW)
            View(grid).render(View.MATPLOTLIB)
        return grid

    def save(self) -> Optional[str]:
        """(renderer.py:363) finalize the recording and return its path
        (None if nothing was recorded); the next recording starts a new
        file."""
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        return self._path


_module_renderer: Optional[Renderer] = None


def render(views: Sequence[View], renderer: str = "cv", size=None,
           record_file: Optional[str] = None, fps=30, grid_size=None,
           skip_views=False):
    """Module-level convenience (aloscene/__init__.py:33) over one
    persistent Renderer, so that calls with ``record_file`` append to one
    mp4 until ``render_save``."""
    global _module_renderer
    if _module_renderer is None:
        _module_renderer = Renderer()
    return _module_renderer.render(views, renderer=renderer,
                                   cell_grid_size=size,
                                   record_file=record_file, fps=fps,
                                   grid_size=grid_size, skip_views=skip_views)


def render_save():
    """Finalize the module-level renderer, returning its recording's path
    (None if it recorded nothing)."""
    global _module_renderer
    if _module_renderer is None:
        return None
    path = _module_renderer.save()
    _module_renderer = None
    return path
