"""Training (PyTorch counterpart of ``aloception_tpu/train``): the optimizer,
train and eval steps, checkpoints, callbacks, the Trainer and the DETR and
Deformable-DETR trainer factories."""

from .callbacks import Callback, MetricsCallback  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .data_modules import CocoDetection2Detr, pick_bucket  # noqa: F401
from .experiment import find_run_dir, get_expe_infos  # noqa: F401
from .logger import NoOpLogger, make_logger  # noqa: F401
from .state import TrainOptimizer, onecycle_schedule  # noqa: F401
from .step import make_detr_train_step, make_eval_step  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .trainers import (make_deformable_detr_trainer,  # noqa: F401
                       make_detr_trainer)
