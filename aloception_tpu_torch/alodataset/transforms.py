"""Label-aware train transforms of fixed-size detection training (counterpart
of the ``Compose``, ``RandomHorizontalFlip``, ``RandomResizeWithAspectRatio``
and ``Resize`` of ``aloception_tpu/alodataset/transforms.py``).

Geometry goes through the aloscene ops, so boxes move with the frames. The
random draws come from a ``torch.Generator`` that the caller seeds (the JAX
package draws from Python's ``random``): the same distributions, not the
same draws. The other transforms wait in ROADMAP A10.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..aloscene import Frame


def _uniform(generator: Optional[torch.Generator]) -> float:
    return float(torch.rand((), generator=generator))


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, frame: Frame) -> Frame:
        for t in self.transforms:
            frame = t(frame)
        return frame


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = generator

    def __call__(self, frame: Frame) -> Frame:
        return frame.hflip() if _uniform(self.generator) < self.p else frame


class RandomResizeWithAspectRatio:
    """Resize so that the shorter side is a size drawn from ``sizes``, the
    longer side at most ``max_size``."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.generator = generator

    @staticmethod
    def get_size_with_aspect_ratio(frame: Frame, size: int,
                                   max_size: Optional[int] = None
                                   ) -> Tuple[int, int]:
        h, w = frame.H, frame.W
        if max_size is not None:
            mn, mx = float(min(w, h)), float(max(w, h))
            if mx / mn * size > max_size:
                size = int(round(max_size * mn / mx))
        if (w <= h and w == size) or (h <= w and h == size):
            return (h, w)
        if w < h:
            return (int(size * h / w), size)
        return (size, int(size * w / h))

    def __call__(self, frame: Frame) -> Frame:
        size = self.sizes[int(torch.randint(len(self.sizes), (),
                                            generator=self.generator))]
        return frame.resize(self.get_size_with_aspect_ratio(frame, size,
                                                            self.max_size))


class Resize:
    def __init__(self, size: Tuple[int, int]):
        self.size = tuple(size)

    def __call__(self, frame: Frame) -> Frame:
        return frame.resize(self.size)
