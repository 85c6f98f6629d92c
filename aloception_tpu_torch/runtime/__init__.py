"""The native image decoder and batch loader (counterpart of
``aloception_tpu/runtime``)."""

from .loader import NativeImageLoader, decode, fill_poly  # noqa: F401
