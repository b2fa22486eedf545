from lmnet_tpu_torch.train import checkpoint
from lmnet_tpu_torch.train.engine import (
    TrainState,
    cosine_epoch_schedule,
    create_train_state,
    eval_step,
    make_optimizer,
    train_step,
)
from lmnet_tpu_torch.train.loop import evaluate, train_one_epoch, visualize

__all__ = [
    "TrainState",
    "checkpoint",
    "cosine_epoch_schedule",
    "create_train_state",
    "eval_step",
    "evaluate",
    "make_optimizer",
    "train_one_epoch",
    "train_step",
    "visualize",
]
