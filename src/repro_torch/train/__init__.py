"""Training: AdamW with the WSD and cosine schedules, and the train step."""

from .optim import AdamWConfig, adamw_init, adamw_update, lr_at_step, wsd_schedule
from .step import TrainStepConfig, make_eval_step, make_train_step

__all__ = [
    "AdamWConfig",
    "TrainStepConfig",
    "adamw_init",
    "adamw_update",
    "lr_at_step",
    "make_eval_step",
    "make_train_step",
    "wsd_schedule",
]
