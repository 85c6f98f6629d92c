"""The native image decoder and batch loader (counterpart of
``aloception_tpu/runtime``)."""

from .loader import (NativeImageLoader, decode, decode_bytes,  # noqa: F401
                     fill_poly, resize_linear_u8)
