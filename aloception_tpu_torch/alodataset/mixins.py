"""Dataset mixins (counterpart of ``aloception_tpu/alodataset/mixins.py``):
temporal sequence options and the split -> folder mapping."""

from __future__ import annotations


class SequenceMixin:
    """Temporal sequence options."""

    def __init__(self, sequence_size: int = 2, sequence_skip: int = 0,
                 **kwargs):
        self.sequence_size = sequence_size
        self.sequence_skip = sequence_skip
        super().__init__(**kwargs)


class SplitMixin:
    """train/val/test folder mapping: subclasses set ``SPLIT_FOLDERS`` and
    ``self.split``."""

    SPLIT_FOLDERS: dict = {}

    def get_split_folder(self) -> str:
        return self.SPLIT_FOLDERS[self.split]
