"""The port's training core: state, the step, and the fault-tolerant
loop."""

from repro_torch.training.train_state import (
    TrainState,
    abstract_train_state,
    init_train_state,
    train_state_pspecs,
)
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["TrainState", "abstract_train_state", "init_train_state",
           "make_train_step", "train_state_pspecs", "Trainer",
           "TrainerConfig"]
