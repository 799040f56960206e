"""Training of the port: the pure train and eval steps (Adam + EMA + MSE)
and their data-parallel forms, checkpoints and train-state resume in the
JAX package's formats, and the ``Trainer``, on one device or over the ranks
of a ``parallel.Mesh``."""

from gelslim_depth_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_quantized,
    load_train_state,
    save_quantized,
    save_train_state,
    save_weights,
)
from gelslim_depth_tpu_torch.train.ema import EmaState, ema_init, ema_update
from gelslim_depth_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    mse_loss,
)
from gelslim_depth_tpu_torch.train.loop import Trainer

__all__ = [
    "save_weights",
    "load_checkpoint",
    "save_train_state",
    "load_train_state",
    "save_quantized",
    "load_quantized",
    "EmaState",
    "ema_init",
    "ema_update",
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "mse_loss",
    "Trainer",
]
