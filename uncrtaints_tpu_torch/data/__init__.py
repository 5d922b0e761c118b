"""Data for the port.

- :mod:`preprocess` -- radiometry rescaling (``process_MS`` on the host,
  ``process_MS_device`` / ``process_SAR_device`` on tensors; raw-DN batches
  keep their uint16 codes and are rescaled inside the eval and train steps)
- :mod:`synthetic`  -- synthetic source with the sample structure of the
  real datasets (tests and smoke runs)
- :mod:`pipeline`   -- host-side batching, shuffling, prefetch and
  per-process sharding
"""

from uncrtaints_tpu_torch.data.pipeline import (  # noqa: F401
    BatchLoader, Subset, collate_mono, collate_multi, make_fast_collate,
    make_raw_collate, pad_collate_multi, select_collate)
from uncrtaints_tpu_torch.data.preprocess import (  # noqa: F401
    process_MS, process_MS_device, process_SAR_device)
from uncrtaints_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSEN12MSCR, SyntheticSEN12MSCRTS)
