"""BaseDataset: datasets that emit aloscene Frames, and their loaders
(counterpart of ``aloception_tpu/alodataset/base_dataset.py``).

- The dataset directory comes from ``dataset_dir=`` (then remembered) or
  from the user's config ``~/.aloception_tpu/alodataset_config.json``, the
  JAX package's file.
- ``__getitem__`` retries an index whose sample raises
  ``InvalidSampleError`` at ``idx + retry_offset``, at most
  ``max_retry_on_error`` times, then applies ``transform_fn``.
- With ``transform_seed``, ``transform_fn(sample, generator)`` draws from a
  generator of its own for each (seed, epoch, index)
  (``sample_generator``): the draws do not depend on which worker thread
  makes the sample, or when. Without it ``transform_fn(sample)``.
- ``stream_loader``: the samples in order; ``train_loader``: lists of
  samples (batched later by ``aloscene.batch_list``), reshuffled each epoch
  by ``np.random.RandomState(seed + epoch)``, the JAX loader's order.

Samples are made by worker threads that keep a bounded number ready ahead
of the consumer, in order. Decoding (Pillow, or the native loader through
ctypes) and torch's CPU ops release the interpreter lock, so the workers
overlap each other and the training step. The frames are CPU tensors.
"""

from __future__ import annotations

import json
import os
import threading
from enum import Enum
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..aloscene import InvalidSampleError

CONFIG_PATH = os.path.expanduser("~/.aloception_tpu/alodataset_config.json")


class Split(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"

    @classmethod
    def list(cls):
        return [s for s in cls]


def load_dataset_config() -> dict:
    if os.path.exists(CONFIG_PATH):
        with open(CONFIG_PATH) as f:
            return json.load(f)
    return {}


def save_dataset_config(cfg: dict):
    os.makedirs(os.path.dirname(CONFIG_PATH), exist_ok=True)
    with open(CONFIG_PATH, "w") as f:
        json.dump(cfg, f, indent=2)


def sample_generator(seed: int, epoch: int, idx: int) -> torch.Generator:
    """The generator of one sample's draws, a function of (seed, epoch,
    index) alone."""
    hi, lo = np.random.SeedSequence([seed, epoch, idx]).generate_state(2)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


class BaseDataset:
    """Subclasses set ``self.items`` (indexable) and implement
    ``getitem``."""

    def __init__(self, name: str, dataset_dir: Optional[str] = None,
                 transform_fn: Optional[Callable] = None, sample: bool = False,
                 max_retry_on_error: int = 3, retry_offset: int = 17,
                 transform_seed: Optional[int] = None, **kwargs):
        self.name = name
        self.sample = sample
        self.transform_fn = transform_fn
        self.transform_seed = transform_seed
        self.max_retry_on_error = max_retry_on_error
        self.retry_offset = retry_offset
        self.items: List[Any] = []
        self.dataset_dir = None if sample else self.get_dataset_dir(
            dataset_dir)

    def get_dataset_dir(self, dataset_dir: Optional[str] = None) -> str:
        """``dataset_dir`` (written to the config when it is new), else the
        config's entry for ``self.name``, else asked on a terminal; raises
        ``FileNotFoundError`` without one."""
        cfg = load_dataset_config()
        if dataset_dir is not None:
            dataset_dir = os.path.expanduser(dataset_dir)
            if cfg.get(self.name) != dataset_dir:
                cfg[self.name] = dataset_dir
                save_dataset_config(cfg)
            return dataset_dir
        if self.name in cfg:
            return cfg[self.name]
        if os.isatty(0):
            path = input(f"Path to the '{self.name}' dataset directory: "
                         ).strip()
            path = os.path.expanduser(path)
            cfg[self.name] = path
            save_dataset_config(cfg)
            return path
        raise FileNotFoundError(
            f"dataset dir for '{self.name}' not configured; add it to "
            f"{CONFIG_PATH} or pass dataset_dir=")

    def __len__(self) -> int:
        return len(self.items)

    def getitem(self, idx: int):
        raise NotImplementedError

    def __getitem__(self, idx: int):
        return self.get(idx)

    def get(self, idx: int, epoch: int = 0):
        """The sample at ``idx`` (retried as above), transformed as in
        ``epoch``."""
        total, asked = len(self), idx
        for attempt in range(self.max_retry_on_error + 1):
            try:
                data = self.getitem(idx)
                break
            except InvalidSampleError:
                if attempt == self.max_retry_on_error:
                    raise
                idx = (idx + self.retry_offset) % max(total, 1)
        return self.transform(data, asked, epoch)

    def transform(self, data, idx: int, epoch: int = 0):
        """``transform_fn`` applied to the sample of ``idx``."""
        if self.transform_fn is None:
            return data
        if self.transform_seed is None:
            return self.transform_fn(data)
        return self.transform_fn(
            data, sample_generator(self.transform_seed, epoch, idx))

    def stream_loader(self, num_workers: int = 2) -> "PrefetchIterator":
        """The samples one by one, in order."""
        return PrefetchIterator(self, range(len(self)), num_workers,
                                batch_size=None)

    def train_loader(self, batch_size: int = 1, num_workers: int = 2,
                     shuffle: bool = True, seed: Optional[int] = 0,
                     drop_last: bool = True) -> "LoaderFactory":
        """Re-iterable loader of lists of ``batch_size`` samples."""
        return LoaderFactory(self, batch_size, num_workers, shuffle, seed,
                             drop_last)


class LoaderFactory:
    """Re-iterable loader: each iteration is an epoch, shuffled by
    ``np.random.RandomState(seed + epoch)`` (``seed=None``: unseeded)."""

    def __init__(self, dataset, batch_size: int, num_workers: int,
                 shuffle: bool, seed: Optional[int], drop_last: bool):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> "PrefetchIterator":
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(None if self.seed is None
                                  else self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        return PrefetchIterator(self.dataset, order, self.num_workers,
                                batch_size=self.batch_size,
                                drop_last=self.drop_last,
                                epoch=self._epoch - 1)


class _Queue:
    """The workers' shared state: the next sample to make, the samples made
    and not yet taken, and whether the consumer has closed. The worker
    threads hold this, not the iterator, so an iterator that is dropped is
    collected, and closes them."""

    def __init__(self, dataset, order: List[int], end: int, workers: int,
                 prefetch: int, epoch: int):
        self.dataset, self.order, self.end = dataset, order, end
        self.epoch = epoch
        self.ahead = prefetch + workers
        self.results: dict = {}
        self.next_submit = 0
        self.closed = False
        self.cv = threading.Condition()

    def work(self):
        while True:
            with self.cv:
                while (not self.closed and self.next_submit < self.end
                       and len(self.results) >= self.ahead):
                    self.cv.wait()
                if self.closed or self.next_submit >= self.end:
                    return
                i = self.next_submit
                self.next_submit += 1
            try:
                res = self.dataset.get(self.order[i], self.epoch)
            except Exception as e:  # raised to the consumer at its turn
                res = e
            with self.cv:
                self.results[i] = res
                self.cv.notify_all()

    def take(self, i: int):
        with self.cv:
            while i not in self.results:
                self.cv.wait()
            res = self.results.pop(i)
            self.cv.notify_all()
        if isinstance(res, Exception):
            raise res
        return res

    def close(self):
        with self.cv:
            self.closed = True
            self.results.clear()
            self.cv.notify_all()


class PrefetchIterator:
    """Samples of ``dataset`` in ``order``, made by ``num_workers`` threads
    at most ``prefetch + num_workers`` ahead of the consumer (0 workers:
    made in the consumer's thread), transformed as in ``epoch``; batched as
    lists when ``batch_size`` is set. A sample's exception is raised to the
    consumer at its turn.
    ``close()`` (also on exhaustion and garbage collection) stops the
    workers."""

    def __init__(self, dataset, order, num_workers: int,
                 batch_size: Optional[int] = None, drop_last: bool = True,
                 prefetch: int = 8, epoch: int = 0):
        self.dataset = dataset
        self.epoch = epoch
        self.order = [int(i) for i in order]
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 0)
        n = len(self.order)
        if batch_size is not None and drop_last:
            n = n // batch_size * batch_size
        self._end = n                   # samples that will be yielded
        self._next_yield = 0
        self._queue = _Queue(dataset, self.order, n, self.num_workers,
                             prefetch, epoch)
        for _ in range(self.num_workers):
            threading.Thread(target=self._queue.work, daemon=True).start()

    def _get(self, i: int):
        if not self.num_workers:
            return self.dataset.get(self.order[i], self.epoch)
        return self._queue.take(i)

    def close(self):
        self._queue.close()

    def __del__(self):
        self.close()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        start = self._next_yield
        if start >= self._end:
            self.close()
            raise StopIteration
        stop = start + 1 if self.batch_size is None else min(
            start + self.batch_size, self._end)
        items = [self._get(i) for i in range(start, stop)]
        self._next_yield = stop
        return items[0] if self.batch_size is None else items
