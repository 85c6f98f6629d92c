from .detr import Detr, detr_r50, inference, inference_arrays  # noqa: F401
