"""The eval step: forward, MGNLL loss, the scale_by rescale and the image
metrics, without gradients.

Port of the serving half of uncrtaints_tpu/train/engine.py (_prepare_xy,
_split_out, the cast policy of _cast_for_forward, make_eval_step). The cast
policy is written out with explicit casts, not torch.autocast, so that the
values are rounded where the JAX package rounds them:

- parameters and the input are cast to the compute dtype (bf16) for the
  forward; batch-norm running statistics stay fp32;
- norm statistics are fp32 (inside the layers);
- loss and metrics are computed in fp32 on the upcast output.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.func import functional_call

from uncrtaints_tpu_torch.config import Config
from uncrtaints_tpu_torch.data.preprocess import process_MS_device
from uncrtaints_tpu_torch.losses import calc_loss, get_loss
from uncrtaints_tpu_torch.models.registry import mean_vars_idx


def batch_to_device(batch: Dict, device) -> Dict:
    """numpy batch (collate output) -> tensors on ``device``. Arrays keep
    their dtype, raw uint16 DN codes included; other values pass as they
    are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def _split_out(out: torch.Tensor, cfg: Config):
    mean_idx, vars_idx = mean_vars_idx(cfg)
    var = out[..., mean_idx:vars_idx] if vars_idx > mean_idx else None
    return out[..., :mean_idx], var


def _compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _prepare_xy(cfg: Config, batch: Dict, rescale_method: str = "default"):
    """(x_scaled, y_scaled, y_unscaled) in fp32 from either batch form.

    Generic form: {'x', 'y'} already processed on the host. Raw-DN form:
    {'x_s2dn', 'y_dn'} uint16 Sentinel-2 codes plus optional processed
    {'x_s1'}; the radiometry runs here, on the device. The scale_by multiply
    is in fp32 whatever dtype the batch was collated in."""
    s = cfg.scale_by
    if "x_s2dn" in batch:
        s2 = process_MS_device(batch["x_s2dn"].to(torch.float32), rescale_method)
        if batch.get("x_s1") is not None:
            x = torch.cat([batch["x_s1"].to(torch.float32), s2], dim=-1)
        else:
            x = s2
        y_u = process_MS_device(batch["y_dn"].to(torch.float32), rescale_method)
        return s * x, s * y_u, y_u
    y = batch["y"].to(torch.float32)
    return s * batch["x"].to(torch.float32), s * y, y


def _cast_for_forward(cfg: Config, model: torch.nn.Module, x: torch.Tensor):
    """Parameters (not buffers) and input in the compute dtype."""
    dt = _compute_dtype(cfg)
    params = {name: p.to(dt) if p.is_floating_point() else p
              for name, p in model.named_parameters()}
    return params, x.to(dt)


def make_eval_step(cfg: Config, with_metrics: bool = False,
                   rescale_method: str = "default",
                   return_outputs: bool = True) -> Callable:
    """Build ``eval_step(model, batch) -> {'loss', 'pred', 'var',
    'metrics'}`` (the reference's val/test branch).

    ``batch`` holds tensors on the model's device (:func:`batch_to_device`).
    The step runs under ``torch.inference_mode()`` with the model in eval
    mode. ``pred`` and ``var`` are rescaled to data units (mean / scale_by,
    variance / scale_by^2); ``with_metrics`` adds {name: [B]} image metrics;
    ``return_outputs=False`` (with metrics only) leaves pred and var out."""
    if not return_outputs and not with_metrics:
        raise ValueError("return_outputs=False requires with_metrics=True "
                         "(the step would compute nothing observable)")
    criterion = get_loss(cfg)
    s = cfg.scale_by

    @torch.inference_mode()
    def eval_step(model: torch.nn.Module, batch: Dict) -> Dict:
        model.eval()
        x, y, y_u = _prepare_xy(cfg, batch, rescale_method)
        params, xc = _cast_for_forward(cfg, model, x)
        dates = batch.get("dates")
        out = functional_call(model, params, (xc,),
                              {"batch_positions": dates})
        mean, var = _split_out(out.float(), cfg)
        loss, variance = calc_loss(criterion, cfg, mean, y, var=var)
        pred = mean / s
        rvar = variance / (s * s) if variance is not None else None
        aux = {"loss": loss}
        if return_outputs:
            aux["pred"] = pred
            if rvar is not None:
                aux["var"] = rvar
        if with_metrics:
            from uncrtaints_tpu_torch.metrics.image import img_metrics_batch
            aux["metrics"] = img_metrics_batch(y_u, pred, var=rvar)
        return aux

    return eval_step
