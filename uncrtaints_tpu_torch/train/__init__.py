"""The port's steps: train and eval."""

from uncrtaints_tpu_torch.train.engine import (  # noqa: F401
    Adam, AdamState, TrainState, batch_to_device, create_train_state, epoch_lr,
    make_eval_step, make_optimizer, make_train_step, set_learning_rate)
