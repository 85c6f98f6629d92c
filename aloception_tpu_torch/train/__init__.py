"""Training (PyTorch counterpart of ``aloception_tpu/train``): the optimizer,
train and eval steps, checkpoints, callbacks, the data modules, the Trainer
and the trainer factories of DETR, Deformable-DETR, the panoptic head and
RAFT."""

from .callbacks import (ApMetricsCallback, Callback,  # noqa: F401
                        EPECallback, MetricsCallback, ObjectDetectorCallback,
                        PQMetricsCallback)
from .checkpoint import CheckpointManager  # noqa: F401
from .data_modules import (CocoDetection2Detr, Data2RAFT,  # noqa: F401
                           pick_bucket)
from .experiment import find_run_dir, get_expe_infos  # noqa: F401
from .logger import NoOpLogger, make_logger  # noqa: F401
from .state import TrainOptimizer, onecycle_schedule  # noqa: F401
from .step import (make_detr_train_step, make_eval_step,  # noqa: F401
                   make_train_step)
from .trainer import Trainer  # noqa: F401
from .trainers import (make_deformable_detr_trainer,  # noqa: F401
                       make_detr_trainer, make_panoptic_trainer,
                       make_raft_trainer)
