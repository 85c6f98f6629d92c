"""Datasets and transforms (PyTorch counterpart of
``aloception_tpu/alodataset``). Ported so far: the offline synthetic COCO
detection (with masks), COCO panoptic, Sintel and FlyingChairs2 flow samples
and the fixed-size detection train transforms; the datasets on disk and the
others wait in ROADMAP A10."""

from .coco_detection import CocoBaseDataset  # noqa: F401
from .coco_panoptic import CocoPanopticDataset, id2rgb, rgb2id  # noqa: F401
from .flying_chairs2 import FlyingChairs2Dataset  # noqa: F401
from .sintel import SintelFlowDataset  # noqa: F401
