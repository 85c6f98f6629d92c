"""Filesystem helpers of dataset preparation (counterpart of
``aloception_tpu/alodataset/io_utils.py``)."""

from __future__ import annotations

import os
import shutil


def move_and_replace(src_dir: str, dst_dir: str):
    """Merge ``src_dir`` into ``dst_dir``, replacing files that collide, and
    remove the emptied source folders (prepare steps that unpack archives
    incrementally)."""
    os.makedirs(dst_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        src = os.path.join(src_dir, name)
        dst = os.path.join(dst_dir, name)
        if os.path.isdir(src):
            move_and_replace(src, dst)
            try:
                os.rmdir(src)
            except OSError:
                pass
        else:
            if os.path.exists(dst):
                os.remove(dst)
            shutil.move(src, dst)
