"""Training logging (counterpart of ``aloception_tpu/train/logger.py``).

Only the no-op logger is ported; the TensorBoard logger waits in ROADMAP A6.
"""

from __future__ import annotations

from typing import Optional


class NoOpLogger:
    def log_scalar(self, *a, **kw): pass
    def log_scalars(self, *a, **kw): pass
    def log_image(self, *a, **kw): pass
    def log_hist(self, *a, **kw): pass
    def flush(self): pass
    def close(self): pass


def make_logger(backend: Optional[str], log_dir: Optional[str] = None):
    """The --log switch: None or "none" is the no-op logger."""
    if backend in (None, "none"):
        return NoOpLogger()
    if backend in ("tensorboard", "tb", "wandb"):
        raise NotImplementedError(
            f"the {backend} logger is not ported yet (ROADMAP A6); train "
            "with log=None")
    raise ValueError(f"unknown logger backend {backend}")
