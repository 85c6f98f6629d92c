"""Per-model exporters (counterpart of
``aloception_tpu/export/model_exporters.py``; reference:
alonet/detr/trt_exporter.py:14, deformable_detr/trt_exporter.py:20,
detr_panoptic/trt_exporter.py:15).

The reference splices a TensorRT plugin into the ONNX graph for its MSDA
CUDA op (deformable_detr/trt_exporter.py:43 MsDeformIm2ColTRT). Here the
MSDA kernel is a registered operator, so the export path is the same for
every model: the Deformable package calls the operator, which launches the
hand-written kernel on the card.

Every exporter exports fixed shapes: a package takes batches of exactly
``batch_size`` items at ``input_shape``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..models.panoptic.panoptic_head import PanopticHead
from .base_exporter import BaseExporter


class DetrExporter(BaseExporter):
    """(detr/trt_exporter.py:14) exports (pred_logits, pred_boxes) from
    images (B, H, W, 3) and a padding mask (B, H, W)."""

    def __init__(self, model: nn.Module,
                 input_shape: Tuple[int, int] = (480, 640), **kwargs):
        kwargs.setdefault("name", "detr")
        super().__init__(model, **kwargs)
        self.input_shape = tuple(input_shape)

    def example_inputs(self):
        h, w = self.input_shape
        return (torch.zeros(self.batch_size, h, w, 3, device=self.device),
                torch.zeros(self.batch_size, h, w, device=self.device))

    def adapt_outputs(self, outputs: Dict) -> Dict:
        return {"pred_logits": outputs["pred_logits"].float(),
                "pred_boxes": outputs["pred_boxes"].float()}


class DeformableDetrExporter(DetrExporter):
    """(deformable_detr/trt_exporter.py:20)"""

    def __init__(self, model: nn.Module, **kwargs):
        kwargs.setdefault("name", "deformable-detr")
        super().__init__(model, **kwargs)


class _DetectorAndHead(nn.Module):
    def __init__(self, detector: nn.Module, head: PanopticHead):
        super().__init__()
        self.detector = detector
        self.head = head

    def forward(self, images, mask):
        # the head's own forward (a DetrPanoptic's would run its detector)
        return PanopticHead.forward(self.head, self.detector(images, mask))


class PanopticExporter(DetrExporter):
    """(detr_panoptic/trt_exporter.py:15) the detector (built with
    ``return_intermediate``) and the panoptic head in one program; exports
    pred_logits, pred_boxes and pred_masks."""

    def __init__(self, detector: nn.Module, head: PanopticHead, **kwargs):
        kwargs.setdefault("name", "panoptic")
        super().__init__(_DetectorAndHead(detector, head), **kwargs)

    def adapt_outputs(self, outputs: Dict) -> Dict:
        return {**super().adapt_outputs(outputs),
                "pred_masks": outputs["pred_masks"].float()}


class RAFTExporter(BaseExporter):
    """Fixed-iteration RAFT (``only_last``): the iterations are unrolled in
    the exported graph. Frames are (B, 3, H, W), the port's layout (the JAX
    package's exporter takes NHWC)."""

    def __init__(self, model: nn.Module,
                 input_shape: Tuple[int, int] = (368, 496), iters: int = 12,
                 **kwargs):
        kwargs.setdefault("name", "raft")
        super().__init__(model, **kwargs)
        self.input_shape = tuple(input_shape)
        self.iters = iters

    def example_inputs(self):
        h, w = self.input_shape
        return tuple(torch.zeros(self.batch_size, 3, h, w, device=self.device)
                     for _ in range(2))

    def forward(self, model: nn.Module, frame1, frame2):
        return model(frame1, frame2, iters=self.iters, only_last=True)

    def adapt_outputs(self, outputs: torch.Tensor) -> torch.Tensor:
        return outputs.float()
