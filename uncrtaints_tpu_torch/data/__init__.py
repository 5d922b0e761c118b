"""Data for the port: the JAX package's synthetic source and numpy collate,
reused as they are (neither imports JAX), and the on-device radiometry.

``uncrtaints_tpu/data/preprocess.py`` imports JAX, so the port's path
avoids what reaches it (``pipeline._decode_raw_s2``, the fallback of
``make_fast_collate``): raw-DN batches keep their uint16 codes and go
through :func:`process_MS_device` inside the eval step.
"""

from uncrtaints_tpu.data.pipeline import collate_multi  # noqa: F401
from uncrtaints_tpu.data.synthetic import SyntheticSEN12MSCRTS  # noqa: F401

from uncrtaints_tpu_torch.data.preprocess import (  # noqa: F401
    process_MS_device, process_SAR_device)
