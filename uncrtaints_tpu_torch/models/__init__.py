"""Models of the port (UnCRtainTS and its building blocks)."""

from uncrtaints_tpu_torch.models.registry import get_generator, mean_vars_idx  # noqa: F401
