"""Production serving handler (counterpart of
``aloception_tpu/export/production/model_handler.py``; reference:
alonet/detr/production/model_handler.py:23 torchserve ModelHandler):
images -> batched inference on an exported package -> JSON boxes.

Items are encoded image bytes (JPEG, WebP, PNG, BMP: decoded by
``runtime.decode_bytes`` to the RGB pixels ``cv2.imdecode`` and
``COLOR_BGR2RGB`` give the JAX handler, EXIF orientation included), uint8
(H, W, 3) arrays or tensors, or ``Frame``s.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import torch

from ...aloscene import Frame
from ...runtime import decode_bytes


class ModelHandler:
    """preprocess / inference / postprocess (model_handler.py:23-131). The
    batch must hold the package's exported batch size of items."""

    def __init__(self, input_size=(480, 640), threshold: float = 0.2,
                 background_class: Optional[int] = 91,
                 labels_names: Optional[List[str]] = None):
        self.input_size = tuple(input_size)
        self.threshold = threshold
        self.background_class = background_class
        self.labels_names = labels_names
        self.executor = None
        self.device = None
        self.initialized = False

    def initialize(self, artifact):
        """(model_handler.py initialize) load the exported package at the
        path ``artifact``, or take an ``Executor`` that has loaded it, and
        time its calls; the handler works on the device it was compiled
        for."""
        from ..executor import Executor, Profiler
        if isinstance(artifact, Executor):
            self.executor = artifact
            if self.executor.profiler is None:
                self.executor.profiler = Profiler()
        else:
            self.executor = Executor(artifact, profiling=True)
        self.device = torch.device(self.executor.meta.get("device", "cuda"))
        self.initialized = True

    def preprocess(self, batch: List[Any]) -> Dict[str, torch.Tensor]:
        """Images -> resnet-normalised NHWC batch and a zero padding mask on
        the package's device (model_handler.py preprocess); encoded bytes
        are decoded on the host first."""
        h, w = self.input_size
        images = []
        for item in batch:
            if isinstance(item, (bytes, bytearray)):
                item = decode_bytes(item, "color")
            if isinstance(item, Frame):
                frame = item.to(self.device)
            else:
                x = torch.as_tensor(item).to(self.device)
                frame = Frame(x.permute(2, 0, 1).float())
            frame = frame.norm_resnet().resize((h, w))
            images.append(frame.as_layout(("H", "W", "C")))
        images = torch.stack(images).float()
        mask = torch.zeros(images.shape[:3], device=images.device)
        return {"images": images, "mask": mask}

    def inference(self, inputs: Dict[str, torch.Tensor]):
        if not self.initialized:
            raise RuntimeError("call initialize(artifact_path) first")
        return self.executor(inputs["images"], inputs["mask"])

    def postprocess(self, outputs) -> List[str]:
        """Model dict -> JSON boxes per image (model_handler.py
        postprocess): softmax, best class, threshold and background on the
        device, then one fetch."""
        probs = outputs["pred_logits"].float().softmax(-1)
        scores, labels = probs.max(-1)
        keep = scores > self.threshold
        if self.background_class is not None:
            keep &= labels != self.background_class
        host = torch.cat([scores[..., None], labels[..., None].float(),
                          keep[..., None].float(),
                          outputs["pred_boxes"].float()], -1).cpu().numpy()
        results = []
        for rows in host:
            dets = []
            for score, label, kept, *box in rows:
                if not kept:
                    continue
                name = self.labels_names[int(label)] \
                    if self.labels_names else int(label)
                dets.append({"label": name, "score": float(score),
                             "box_xcyc_rel": [float(v) for v in box]})
            results.append(json.dumps(dets))
        return results

    def handle(self, batch: List[Any]) -> List[str]:
        return self.postprocess(self.inference(self.preprocess(batch)))
