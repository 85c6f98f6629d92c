"""aloscene (PyTorch): augmented tensors, labeled data structures that
transform together (counterpart of ``aloception_tpu/aloscene``). Ported so
far: the core, ``Labels``, ``BoundingBoxes2D``, ``Mask``, ``Flow`` and
``Frame``."""

from .augmented import AugmentedArray
from .spatial import SpatialAugmentedArray
from .labels import Labels
from .bounding_boxes_2d import BoundingBoxes2D
from .mask import Mask
from .flow import Flow
from .frame import Frame

batch_list = SpatialAugmentedArray.batch_list
temporal_list = SpatialAugmentedArray.temporal_list

__all__ = ["AugmentedArray", "SpatialAugmentedArray", "Labels",
           "BoundingBoxes2D", "Mask", "Flow", "Frame", "batch_list",
           "temporal_list"]
