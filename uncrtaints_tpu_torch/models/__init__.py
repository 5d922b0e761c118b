"""Models of the port: UnCRtainTS and its building blocks, and the baseline
families (U-Net, U-TAE, UNet3D, the recurrent models)."""

from uncrtaints_tpu_torch.models.registry import get_generator, mean_vars_idx  # noqa: F401
