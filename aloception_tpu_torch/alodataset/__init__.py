"""Datasets and transforms (PyTorch counterpart of
``aloception_tpu/alodataset``). Ported so far: the offline synthetic COCO
detection (with masks), COCO panoptic and Sintel flow samples and the
fixed-size detection train transforms; the datasets on disk and the others
wait in ROADMAP A10."""

from .coco_detection import CocoBaseDataset  # noqa: F401
from .coco_panoptic import CocoPanopticDataset, id2rgb, rgb2id  # noqa: F401
from .sintel import SintelFlowDataset  # noqa: F401
