"""Data for the port.

- :mod:`preprocess`  -- radiometry rescaling (``process_MS`` / ``process_SAR``
  on the host, ``process_MS_device`` / ``process_SAR_device`` on tensors;
  raw-DN batches keep their uint16 codes and are rescaled inside the eval
  and train steps)
- :mod:`masks`       -- cloud and shadow detection on the card
- :mod:`samplers`    -- fixed / fixedsubset / random time-point samplers
- :mod:`rois`        -- the ROI tables and official splits
- :mod:`tiff`        -- the (Geo)TIFF codec the datasets read without GDAL
- :mod:`s2cloudless` -- the LightGBM cloud detector (weights not included)
- :mod:`sen12mscrts` -- SEN12MS-CR-TS multi-temporal dataset
- :mod:`sen12mscr`   -- SEN12MS-CR mono-temporal dataset
- :mod:`hdf5`        -- the HDF5 source and its converter (h5py optional)
- :mod:`synthetic`   -- synthetic source with the sample structure of the
  real datasets (tests and smoke runs)
- :mod:`pipeline`    -- host-side batching, shuffling, prefetch and
  per-process sharding
"""

from uncrtaints_tpu_torch.data.masks import get_cloud_map  # noqa: F401
from uncrtaints_tpu_torch.data.pipeline import (  # noqa: F401
    BatchLoader, Subset, collate_mono, collate_multi, make_fast_collate,
    make_raw_collate, pad_collate_multi, select_collate)
from uncrtaints_tpu_torch.data.preprocess import (  # noqa: F401
    process_MS, process_MS_device, process_SAR, process_SAR_device)
from uncrtaints_tpu_torch.data.sen12mscr import SEN12MSCR  # noqa: F401
from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS  # noqa: F401
from uncrtaints_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSEN12MSCR, SyntheticSEN12MSCRTS)
