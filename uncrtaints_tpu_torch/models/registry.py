"""Config-driven model construction (the uncrtaints branch of
uncrtaints_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from uncrtaints_tpu_torch.config import Config, input_dim
from uncrtaints_tpu_torch.models.layers import init_weights

S2_BANDS = 13


def mean_vars_idx(cfg: Config):
    """Channel split points for the mean and variance heads."""
    covar_dim = {"uni": S2_BANDS, "iso": 1, "diag": S2_BANDS}.get(cfg.covmode, 0)
    if cfg.loss not in ("GNLL", "MGNLL"):
        covar_dim = 0
    return S2_BANDS, S2_BANDS + covar_dim


def _resolve_fused_eval(cfg: Config, device: torch.device) -> bool:
    """``fused_eval``: 'on', 'off', or 'auto'.

    'auto' is on for a CUDA device, where the fused eval MBConv runs its two
    pointwise GEMMs through the hand-written kernel K3; that is the path the
    port brings up and measures. On the CPU it is off: the kernel's plain
    version there only adds work to the standard body."""
    mode = getattr(cfg, "fused_eval", "auto")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_eval must be auto, on or off, not {mode!r}")
    if mode == "auto":
        return device.type == "cuda"
    return mode == "on"


def get_generator(cfg: Config, device: Union[str, torch.device] = "cpu",
                  generator: Optional[torch.Generator] = None):
    """Build the model for ``cfg`` on ``device``. Weights are drawn on the
    CPU from ``generator`` (default: seeded with ``cfg.rdm_seed``), so one
    seed gives the same model on every device; convolution weights are
    stored ``channels_last``."""
    if cfg.model != "uncrtaints":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    from uncrtaints_tpu_torch.models.uncrtaints import UNCRTAINTS
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.rdm_seed)
    model = UNCRTAINTS(
        input_dim=input_dim(cfg),
        encoder_widths=tuple(cfg.encoder_widths),
        decoder_widths=tuple(cfg.decoder_widths),
        out_conv=tuple(cfg.out_conv),
        out_nonlin_mean=cfg.mean_nonLinearity,
        out_nonlin_var=cfg.var_nonLinearity,
        agg_mode=cfg.agg_mode,
        encoder_norm=cfg.encoder_norm,
        decoder_norm=cfg.decoder_norm,
        n_head=cfg.n_head,
        d_model=cfg.d_model,
        d_k=cfg.d_k,
        pad_value=cfg.pad_value,
        padding_mode=cfg.padding_mode,
        positional_encoding=cfg.positional_encoding,
        covmode=cfg.covmode,
        scale_by=cfg.scale_by,
        separate_out=cfg.separate_out,
        use_v=cfg.use_v,
        block_type=cfg.block_type,
        is_mono=cfg.pretrain,
        low_res_size=cfg.low_res_size,
        fused_eval=_resolve_fused_eval(cfg, device),
    )
    init_weights(model, generator)
    return model.to(device=device, memory_format=torch.channels_last)
