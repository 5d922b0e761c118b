"""Data for the port: the synthetic source, the numpy collate and the
on-device radiometry. Raw-DN batches keep their uint16 codes and go through
:func:`process_MS_device` inside the eval and train steps.
"""

from uncrtaints_tpu_torch.data.pipeline import collate_multi  # noqa: F401
from uncrtaints_tpu_torch.data.preprocess import (  # noqa: F401
    process_MS_device, process_SAR_device)
from uncrtaints_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSEN12MSCR, SyntheticSEN12MSCRTS)
