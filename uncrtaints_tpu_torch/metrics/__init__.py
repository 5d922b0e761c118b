"""Metrics of the port."""

from uncrtaints_tpu_torch.metrics.calibration import (  # noqa: F401
    binarize, compute_ece, compute_uce_auce)
from uncrtaints_tpu_torch.metrics.image import (  # noqa: F401
    AvgImgMetrics, img_metrics, img_metrics_batch)

__all__ = ["img_metrics", "img_metrics_batch", "AvgImgMetrics",
           "compute_ece", "compute_uce_auce", "binarize"]
