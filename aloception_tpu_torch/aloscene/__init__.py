"""aloscene (PyTorch): augmented tensors, labeled data structures that
transform together, their views and the renderer (counterpart of
``aloception_tpu/aloscene``)."""

from .augmented import AugmentedArray
from .spatial import SpatialAugmentedArray
from .labels import Labels
from .bounding_boxes_2d import BoundingBoxes2D
from .bounding_boxes_3d import BoundingBoxes3D
from .oriented_boxes_2d import OrientedBoxes2D
from .camera_calib import CameraExtrinsic, CameraIntrinsic, Pose
from .points_2d import Points2D
from .points_3d import Points3D
from .mask import Mask
from .flow import Flow, SceneFlow
from .depth import Depth
from .disparity import Disparity
from .frame import Frame
from .io.errors import InvalidSampleError
from .renderer import Renderer, View, render, render_save

batch_list = SpatialAugmentedArray.batch_list
temporal_list = SpatialAugmentedArray.temporal_list

__all__ = ["AugmentedArray", "SpatialAugmentedArray", "Labels",
           "BoundingBoxes2D", "BoundingBoxes3D", "OrientedBoxes2D",
           "CameraIntrinsic", "CameraExtrinsic", "Pose", "Points2D",
           "Points3D", "Mask", "Flow", "SceneFlow", "Depth", "Disparity",
           "Frame", "InvalidSampleError", "batch_list", "temporal_list",
           "Renderer", "View", "render", "render_save"]
