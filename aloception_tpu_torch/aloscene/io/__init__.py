"""File readers of the aloscene types (counterpart of
``aloception_tpu/aloscene/io``): flow, disparity and depth files, read on
the host into CPU tensors."""

from .errors import InvalidSampleError  # noqa: F401
