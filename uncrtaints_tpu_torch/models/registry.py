"""Config-driven model construction: every branch of
uncrtaints_tpu/models/registry.py:get_generator (UnCRtainTS, U-Net, U-TAE,
UNet3D, the recurrent baselines)."""

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

    'auto' is on for a CUDA device, where the fused eval MBConv runs as the
    hand-written kernel chain K3 -> K4 -> K3; that is the path the port
    brings up and measures. On the CPU it is off: the kernels' plain
    versions there only add work to the standard body."""
    mode = getattr(cfg, "fused_eval", "auto")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_eval must be auto, on or off, not {mode!r}")
    if mode == "auto":
        return device.type == "cuda"
    return mode == "on"


def _build(cfg: Config, device: torch.device) -> torch.nn.Module:
    """The model ``cfg.model`` names, by the JAX package's rules and in its
    order: "unet3d" before the "unet" substring test, and "utae" with
    ``pretrain`` a U-Net."""
    if cfg.model == "uncrtaints":
        from uncrtaints_tpu_torch.models.uncrtaints import UNCRTAINTS
        return UNCRTAINTS(
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
    if "unet3d" in cfg.model:
        from uncrtaints_tpu_torch.models.unet3d import UNet3D
        return UNet3D(in_channel=input_dim(cfg), out_channel=cfg.out_conv[-1],
                      out_nonlin_mean=cfg.mean_nonLinearity,
                      out_nonlin_var=cfg.var_nonLinearity)
    unet_kw = dict(
        input_dim=input_dim(cfg), encoder_widths=tuple(cfg.encoder_widths),
        decoder_widths=tuple(cfg.decoder_widths), out_conv=tuple(cfg.out_conv),
        out_nonlin_mean=cfg.mean_nonLinearity, out_nonlin_var=cfg.var_nonLinearity,
        encoder_norm=cfg.encoder_norm, decoder_norm=cfg.decoder_norm,
        pad_value=cfg.pad_value, padding_mode=cfg.padding_mode)
    if "unet" in cfg.model or (cfg.model == "utae" and cfg.pretrain):
        from uncrtaints_tpu_torch.models.unet import UNet
        return UNet(**unet_kw)
    if "utae" in cfg.model:
        from uncrtaints_tpu_torch.models.utae import UTAE
        return UTAE(**unet_kw, agg_mode=cfg.agg_mode, n_head=cfg.n_head,
                    d_model=cfg.d_model, d_k=cfg.d_k,
                    positional_encoding=cfg.positional_encoding, scale_by=cfg.scale_by)
    if cfg.model in ("uconvlstm", "buconvlstm", "convlstm", "convgru", "fpn"):
        from uncrtaints_tpu_torch.models.recurrent import build_recurrent
        return build_recurrent(cfg)
    raise NotImplementedError(cfg.model)


def get_generator(cfg: Config, device: Union[str, torch.device, None] = None,
                  generator: Optional[torch.Generator] = None):
    """Build the model for ``cfg`` on ``device`` (default: ``cfg.device``,
    "cuda" unless the config says otherwise; there is no fall-back to the
    CPU when no card is found). Weights are drawn on the CPU from
    ``generator`` (default: seeded with ``cfg.rdm_seed``), so one seed gives
    the same model on every device; convolution weights are stored
    ``channels_last`` (UNet3D's 3-D ones ``channels_last_3d``)."""
    device = torch.device(cfg.device if device is None else device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.rdm_seed)
    model = init_weights(_build(cfg, device), generator)
    fmt = torch.channels_last_3d if "unet3d" in cfg.model else torch.channels_last
    return model.to(device=device, memory_format=fmt)
