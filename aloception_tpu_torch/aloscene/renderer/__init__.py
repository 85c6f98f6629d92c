"""Views, the renderer and the drawing primitives behind them (counterpart
of ``aloception_tpu/aloscene/renderer``)."""

from .renderer import (Renderer, View, put_adaptive_cv2_text,  # noqa: F401
                       render, render_save, resize_view)
