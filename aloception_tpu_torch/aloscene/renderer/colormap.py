"""Colour maps of the depth and disparity views without matplotlib:
``nipy_spectral`` built as matplotlib's ``LinearSegmentedColormap`` builds
it (a 256-entry table interpolated from the segment data, values
``x * 256`` truncated, 1.0 on the last entry), other maps through
matplotlib where it is installed."""

from __future__ import annotations

import functools

import numpy as np

# matplotlib's _nipy_spectral_data: (x, value) at x = 0, 0.05, ..., 1.0
# (the left and right values of every segment are equal)
_NIPY_SPECTRAL = {
    "red": (0.0, 0.4667, 0.5333, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.7333, 0.9333, 1.0, 1.0, 1.0, 0.8667, 0.8, 0.8),
    "green": (0.0, 0.0, 0.0, 0.0, 0.0, 0.4667, 0.6, 0.6667, 0.6667, 0.6,
              0.7333, 0.8667, 1.0, 1.0, 0.9333, 0.8, 0.6, 0.0, 0.0, 0.0,
              0.8),
    "blue": (0.0, 0.5333, 0.6, 0.6667, 0.8667, 0.8667, 0.8667, 0.6667,
             0.5333, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
             0.8),
}
N = 256


def _lookup_table(x: np.ndarray, y: np.ndarray, n: int) -> np.ndarray:
    """matplotlib.colors._create_lookup_table for segments whose two values
    at each x are equal."""
    xind = np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                          + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def nipy_spectral_lut() -> np.ndarray:
    """(256, 3) float64 RGB table."""
    x = np.arange(21) / 20.0     # 0.05, 0.1, 0.15, ... as written
    return np.stack([_lookup_table(x, np.array(_NIPY_SPECTRAL[c]), N)
                     for c in ("red", "green", "blue")], -1)


def apply_colormap(values: np.ndarray, cmap: str = "nipy_spectral"
                   ) -> np.ndarray:
    """``matplotlib.colormaps[cmap](values)[..., :3]`` of float values in
    [0, 1], as float64."""
    if cmap != "nipy_spectral":
        try:
            import matplotlib
        except ImportError as e:
            raise RuntimeError(f"the colour map {cmap!r} needs matplotlib, "
                               f"which is not installed ({e}); "
                               "nipy_spectral needs nothing") from e
        return matplotlib.colormaps[cmap](values)[..., :3]
    xa = np.array(values, np.float64)
    xa *= N
    xa[xa == N] = N - 1
    under, over, bad = xa < 0, xa >= N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    lut = nipy_spectral_lut()
    idx[under] = 0       # the under and over colours are the ends'
    idx[over] = N - 1
    out = lut.take(idx, axis=0, mode="clip")
    out[bad] = 0.0       # the bad colour: transparent black
    return out
