"""Evaluation metrics (counterpart of ``aloception_tpu/metrics``, the
port's own copy): COCO AP, panoptic quality, 3D AP and depth metrics."""

from .ap_metrics import APDataObject, ApMetrics  # noqa: F401
from .ap_metrics_3d import ApMetrics3D  # noqa: F401
from .depth_metrics import DepthMetrics  # noqa: F401
from .pq_metrics import PQMetrics, PQStatCat  # noqa: F401
