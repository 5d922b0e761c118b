"""The port's steps (eval so far)."""

from uncrtaints_tpu_torch.train.engine import batch_to_device, make_eval_step  # noqa: F401
