"""FromDirectoryDataset: the images found in folders (counterpart of
``aloception_tpu/alodataset/from_directory.py``): ``.jpg``, ``.jpeg``,
``.png``, ``.bmp`` and ``.webp`` files, sorted, recursively by default,
decoded by ``runtime.decode``; a file that does not decode raises
``InvalidSampleError``, which the retry of ``__getitem__`` steps over."""

from __future__ import annotations

import glob
import os
from typing import List, Union

from ..aloscene import Frame
from .base_dataset import BaseDataset

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class FromDirectoryDataset(BaseDataset):

    def __init__(self, dirs: Union[str, List[str]],
                 name: str = "from_directory", recursive: bool = True,
                 **kwargs):
        # the folders are given: BaseDataset's sample branch skips the config
        super().__init__(name=name, sample=True, **kwargs)
        self.sample = False
        dirs = [dirs] if isinstance(dirs, str) else dirs
        for d in dirs:
            pattern = os.path.join(d, "**", "*") if recursive \
                else os.path.join(d, "*")
            self.items.extend(p for p in sorted(glob.glob(pattern,
                                                          recursive=recursive))
                              if p.lower().endswith(IMG_EXTENSIONS))

    def getitem(self, idx: int) -> Frame:
        return Frame(self.items[idx])
