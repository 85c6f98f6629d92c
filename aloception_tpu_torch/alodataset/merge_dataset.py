"""MergeDataset: datasets concatenated, each repeated by an integer weight
(counterpart of ``aloception_tpu/alodataset/merge_dataset.py``)."""

from __future__ import annotations

from typing import Callable, List, Optional

from .base_dataset import BaseDataset


class MergeDataset(BaseDataset):
    """Items of ``datasets`` in turn, each dataset's indices repeated
    ``weights[i]`` times; a dataset's own ``transform_fn`` applies to its
    items (a seeded one draws as in epoch 0), then the merge's
    ``transform_fn``."""

    def __init__(self, datasets: List[BaseDataset],
                 weights: Optional[List[int]] = None,
                 transform_fn: Optional[Callable] = None, **kwargs):
        # no directory of its own: BaseDataset's sample branch skips it
        super().__init__(name="merge", sample=True, transform_fn=transform_fn,
                         **kwargs)
        self.sample = any(getattr(d, "sample", False) for d in datasets)
        self.datasets = datasets
        weights = weights if weights is not None else [1] * len(datasets)
        if len(weights) != len(datasets):
            raise ValueError("one weight a dataset")
        self.items = [(d_idx, i)
                      for d_idx, (d, w) in enumerate(zip(datasets, weights))
                      for _ in range(w) for i in range(len(d))]

    def getitem(self, idx: int):
        d_idx, i = self.items[idx]
        dataset = self.datasets[d_idx]
        return dataset.transform(dataset.getitem(i), i)
