"""Dataset-tolerated IO errors (counterpart of
``aloception_tpu/aloscene/io/errors.py``)."""


class InvalidSampleError(Exception):
    """Raised by loaders on corrupted or unsupported samples; datasets catch
    it and retry with a neighbouring index."""
