"""Datasets and transforms (counterpart of ``aloception_tpu/alodataset``):
the base dataset and its threaded loaders, the 26 transforms, COCO
detection, COCO panoptic and LVIS on disk (and their offline synthetic
samples), merge and from-directory datasets, and the Sintel and
FlyingChairs2 flow samples. The flow, 3-D and tracking datasets on disk wait
in ROADMAP A10."""

from .base_dataset import BaseDataset, Split  # noqa: F401
from .mixins import SequenceMixin, SplitMixin  # noqa: F401
from . import transforms  # noqa: F401
from .coco_detection import (CocoBaseDataset,  # noqa: F401
                             CocoDetectionDataset)
from .coco_panoptic import CocoPanopticDataset, id2rgb, rgb2id  # noqa: F401
from .lvis import LvisDataset  # noqa: F401
from .merge_dataset import MergeDataset  # noqa: F401
from .from_directory import FromDirectoryDataset  # noqa: F401
from .flying_chairs2 import FlyingChairs2Dataset  # noqa: F401
from .sintel import SintelFlowDataset  # noqa: F401
