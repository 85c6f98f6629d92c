"""Evaluation metrics (counterpart of ``aloception_tpu/metrics``, the
port's own copy): COCO AP and panoptic quality."""

from .ap_metrics import APDataObject, ApMetrics  # noqa: F401
from .pq_metrics import PQMetrics, PQStatCat  # noqa: F401
