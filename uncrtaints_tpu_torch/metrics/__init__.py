"""Metrics of the port."""

from uncrtaints_tpu_torch.metrics.image import img_metrics_batch  # noqa: F401
