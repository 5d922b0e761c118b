"""The port's steps, the epoch loop, checkpoints and the observer."""

from uncrtaints_tpu_torch.train.engine import (  # noqa: F401
    Adam, AdamState, TrainState, batch_to_device, create_train_state, epoch_lr,
    make_eval_step, make_optimizer, make_train_step, set_learning_rate)

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "make_eval_step", "set_learning_rate", "epoch_lr",
           "Adam", "AdamState", "batch_to_device", "make_optimizer"]
