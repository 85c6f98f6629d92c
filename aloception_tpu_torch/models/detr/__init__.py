from .detr import Detr, detr_r50, inference, inference_arrays  # noqa: F401
from .criterion import detr_criterion, targets_from_frames  # noqa: F401
from .finetune import detr_r50_finetune, finetune_params  # noqa: F401
from .matcher import hungarian_match  # noqa: F401
