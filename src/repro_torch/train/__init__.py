"""Training: AdamW, learning-rate schedules and the train step.

Port of ``repro/train``: ``adamw_update`` is the reference's arithmetic on
dicts of tensors, and ``make_train_step`` runs ``Model.loss`` through
autograd with microbatch accumulation.
"""
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import TrainState, make_train_step, init_train_state
from . import schedule

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "TrainState", "make_train_step", "init_train_state",
    "schedule",
]
