"""Training and evaluation: metrics, learning-rate schedules, the train step
(``trainer``, with the on-device augmentation of ``augment``), the fit loop
and ``resume_training``, full-state checkpoints (``checkpoint``) and
train-time validation."""

from .checkpoint import CheckpointManager  # noqa: F401
from .trainer import (  # noqa: F401
    TrainState,
    build_schedule,
    fit,
    init_train_state,
    make_loss,
    make_optimizer,
    make_train_step,
    resume_training,
)
