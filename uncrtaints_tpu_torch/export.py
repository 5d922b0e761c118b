"""Serving export: a frozen-weight ``torch.export`` artifact (``.pt2``).

Port of uncrtaints_tpu/export.py. ``torch.export`` traces the eval forward
once, with the weights in the program and a symbolic batch dimension, and
``torch.export.save`` writes it to one file. A server loads it and calls it
with no model code, no config and no module tree:

    from uncrtaints_tpu_torch.export import save_serving, load_serving
    save_serving(model, cfg, "model.pt2")           # train-time
    serve = load_serving("model.pt2")               # serving-time
    out = serve(x, dates)                           # {'pred', 'var'}

Outputs equal the eval step's (``train/engine.py:make_eval_step``): the
scale_by protocol (inputs scaled on the way in, mean and variance rescaled
to data units on the way out) and its cast policy (parameters in the compute
dtype, batch-norm statistics fp32), the same operators in the same order.

Unlike the JAX package, which forces the portable XLA aggregation into its
artifact, the exported graph calls the hand-written kernels as the
operators ``torch.ops.uncrtaints.*``: on the card the artifact launches K1,
K3 and K4 as the live eval forward does, on the CPU it runs their plain
versions. Loading needs those operators registered, so :func:`load_serving`
imports ``uncrtaints_tpu_torch.ops`` and nothing of the model code. A
``.pt2`` serves on the device it was exported on (export on the card to
serve there): the JAX package's artifact lowers for several platforms at
once, a ``torch.export`` program holds its device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from uncrtaints_tpu_torch import ops  # noqa: F401  (registers torch.ops.uncrtaints)


class _Serve(torch.nn.Module):
    """The eval forward as a module of (x, dates) -> {'pred', 'var'}: the
    model's parameters in the compute dtype (the casts the eval step makes
    every call, made once), its buffers as they are."""

    def __init__(self, model: torch.nn.Module, cfg):
        super().__init__()
        from uncrtaints_tpu_torch.train.engine import _compute_dtype, _split_out
        self.model = model
        self.scale_by = float(cfg.scale_by)
        self.dtype = _compute_dtype(cfg)
        self.split = lambda out: _split_out(out, cfg)

    def forward(self, x: torch.Tensor, dates: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self.scale_by
        out = self.model((s * x.to(torch.float32)).to(self.dtype), batch_positions=dates)
        mean, var = self.split(out.float())
        res = {"pred": mean / s}
        if var is not None:
            res["var"] = var / (s * s)  # nonlinearity applied in-model
        return res


def make_serve_fn(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """The eval forward as a module of (x [B,T,H,W,C] fp32, dates [B,T]) ->
    {'pred', 'var'}, on a frozen copy of ``model`` in eval mode whose
    parameters are cast to the compute dtype (``cfg.compute_dtype``), as
    ``train/engine.py:eval_forward`` casts them every step."""
    import copy
    from uncrtaints_tpu_torch.train.engine import _compute_dtype
    frozen = copy.deepcopy(model).eval()
    dt = _compute_dtype(cfg)
    for p in frozen.parameters():
        p.requires_grad_(False)
        if p.is_floating_point():
            p.data = p.data.to(dt)
    return _Serve(frozen, cfg).eval()


def export_serving(model: torch.nn.Module, cfg, height: int = 256, width: int = 256,
                   batch: Optional[int] = None) -> torch.export.ExportedProgram:
    """Trace the serving forward into an ``ExportedProgram`` on the model's
    device. ``batch=None`` exports a symbolic batch dimension (any B >= 1 at
    call time); an int pins it, and another batch size is then refused."""
    from uncrtaints_tpu_torch.config import input_dim
    serve = make_serve_fn(model, cfg)
    dev = next(model.parameters()).device
    b = batch if batch is not None else 2  # an example size for the trace
    # (the frozen parameters require no grad, so the trace records no
    # autograd and K3 / K4 trace as the eval forward runs them)
    T, C = cfg.input_t, input_dim(cfg)
    args = (torch.zeros((b, T, height, width, C), device=dev),
            torch.zeros((b, T), device=dev))
    shapes = None
    if batch is None:
        bdim = torch.export.Dim("batch", min=1)
        shapes = {"x": {0: bdim}, "dates": {0: bdim}}
    return torch.export.export(serve, args, dynamic_shapes=shapes, strict=False)


def save_serving(model: torch.nn.Module, cfg, path: str, **kwargs) -> str:
    """Export (:func:`export_serving`) and write the artifact to ``path``."""
    torch.export.save(export_serving(model, cfg, **kwargs), path)
    return path


def load_serving(path: str) -> Callable:
    """Load an artifact; returns ``call(x, dates) -> {'pred', 'var'}``, the
    ``forward_fn`` that ``infer.predict_scene`` takes, on the device the
    artifact was exported on."""
    module = torch.export.load(path).module()

    def call(x: torch.Tensor, dates: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():  # serving: no autograd graph (K3, K4 have no backward)
            return module(x, dates)

    return call
