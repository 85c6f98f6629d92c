"""Deployment export (counterpart of ``aloception_tpu/export``):
torch.export + AOTInductor packages, their executor, int8 quantization and
calibrators, and the serving handler (``export.production``)."""

from .base_exporter import BaseExporter, ExportArtifact  # noqa: F401
from .executor import Executor, Profiler  # noqa: F401
from .quantization import (quantize_weights_int8, quantization_error,  # noqa: F401
                           DataBatchStreamer, MinMaxCalibrator,
                           HistogramCalibrator, PercentileCalibrator,
                           EntropyCalibrator,
                           fake_quant, quantize_params_for_qat)
from .model_exporters import (DetrExporter, DeformableDetrExporter,  # noqa: F401
                              PanopticExporter, RAFTExporter)
