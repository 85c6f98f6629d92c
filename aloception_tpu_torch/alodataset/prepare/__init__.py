"""Dataset preparation converters (counterpart of
``aloception_tpu/alodataset/prepare``)."""
from .waymo_converter import prepare as prepare_waymo  # noqa: F401
