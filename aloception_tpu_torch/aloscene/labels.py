"""Labels: 1-D class ids with optional scores and names (counterpart of
``aloception_tpu/aloscene/labels.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .augmented import AugmentedArray, _bool_index, as_tensor


class Labels(AugmentedArray):
    """Class ids (N,) plus optional per-label ``scores`` and the
    ``labels_names`` vocabulary / ``encoding`` ("id" | "one_hot").

    ``scores`` lives outside the children; indexing, ``.to()``, ``clone()``
    and merging carry it."""

    def __init__(self, x, encoding: str = "id",
                 labels_names: Optional[Sequence[str]] = None,
                 scores=None, names=("N",), **kwargs):
        super().__init__(x, names=names, **kwargs)
        if encoding not in ("id", "one_hot"):
            raise ValueError(f"unknown labels encoding: {encoding}")
        if labels_names is not None:
            labels_names = tuple(labels_names)
        self.add_property("encoding", encoding)
        self.add_property("labels_names", labels_names)
        if scores is not None:
            scores = as_tensor(scores)
            if scores.shape[0] != self.shape[0]:
                raise ValueError(f"{scores.shape[0]} scores for "
                                 f"{self.shape[0]} labels")
        self._scores = scores

    @property
    def scores(self) -> Optional[torch.Tensor]:
        return self._scores

    @scores.setter
    def scores(self, value):
        self._scores = value

    def _with_array(self, array, names=None):
        obj = super()._with_array(array, names=names)
        obj._scores = self._scores
        return obj

    def _map_tensors(self, fn):
        obj = super()._map_tensors(fn)
        if self._scores is not None:
            obj._scores = fn(self._scores)
        return obj

    def __getitem__(self, idx):
        out = super().__getitem__(idx)
        if self._scores is not None:
            if _bool_index(idx):
                idx = torch.as_tensor(idx, device=self._scores.device)
            out._scores = self._scores[idx]
        return out

    # labels are invariant under every geometric op
    def _hflip(self, **kw): return self.clone()
    def _vflip(self, **kw): return self.clone()
    def _resize(self, size01, **kw): return self.clone()
    def _rotate(self, angle, center=None, **kw): return self.clone()
    def _crop(self, H_crop, W_crop, **kw): return self.clone()
    def _pad(self, oy, ox, **kw): return self.clone()
    def _spatial_shift(self, sy, sx, **kw): return self.clone()
