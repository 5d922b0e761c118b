"""Losses of the port."""

from uncrtaints_tpu_torch.losses.losses import (  # noqa: F401
    calc_loss, gaussian_nll_loss, get_loss, l1_loss, l2_loss,
    multi_gaussian_nll_loss)
