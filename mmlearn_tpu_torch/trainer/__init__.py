"""The port's trainer: the fit loop, callbacks, loggers, checkpoints,
checkpoint averaging and the FLOP counter."""

from mmlearn_tpu_torch.trainer.averaging import average_checkpoints
from mmlearn_tpu_torch.trainer.callbacks import (
    Callback,
    LearningRateMonitor,
    ModelCheckpoint,
    Timer,
)
from mmlearn_tpu_torch.trainer.loggers import (
    ConsoleLogger,
    JSONLLogger,
    Logger,
    TensorBoardLogger,
    WandbLogger,
)
from mmlearn_tpu_torch.trainer.state import TrainState
from mmlearn_tpu_torch.trainer.trainer import Trainer

__all__ = [
    "Callback",
    "ConsoleLogger",
    "JSONLLogger",
    "LearningRateMonitor",
    "Logger",
    "ModelCheckpoint",
    "TensorBoardLogger",
    "Timer",
    "TrainState",
    "Trainer",
    "WandbLogger",
    "average_checkpoints",
]
