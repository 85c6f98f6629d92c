"""Image files -> CHW float32 RGB at "255" normalisation (counterpart of
``aloception_tpu/aloscene/io/image.py``, which reads through
``cv2.imread``): decoded by ``runtime.decode``. An unreadable file
raises ``InvalidSampleError``."""

from __future__ import annotations

import torch


def load_image(path: str) -> torch.Tensor:
    from ...runtime import decode
    return decode(path, "color").permute(2, 0, 1).float()
