"""Datasets and transforms (PyTorch counterpart of
``aloception_tpu/alodataset``). Ported so far: the offline synthetic COCO
detection sample and the fixed-size detection train transforms; COCO on disk
and the other datasets wait in ROADMAP A10."""

from .coco_detection import CocoBaseDataset  # noqa: F401
