"""The train and eval steps.

Port of uncrtaints_tpu/train/engine.py: _prepare_xy, _split_out, the cast
policy of _cast_for_forward, make_eval_step (forward, MGNLL loss, the
scale_by rescale and the image metrics, without gradients) and the train
state with make_optimizer, epoch_lr, set_learning_rate, create_train_state
and make_train_step (forward, MGNLL, backward, Adam, the rescale; gradient
accumulation; the freeze mask; data parallel over a process group), and
profile_flops. The cast policy is written out with
explicit casts, not torch.autocast, so that the values are rounded where
the JAX package rounds them:

- the fp32 master parameters and the input are cast to the compute dtype
  (bf16) for the forward, and the gradients flow back through the casts
  to the fp32 masters; batch-norm running statistics stay fp32;
- norm statistics are fp32 (inside the layers);
- loss and metrics are computed in fp32 on the upcast output.

Unlike the JAX step, which returns a new state, the train step updates the
model's parameters, its batch-norm statistics and the optimizer moments in
place (no second copy of them), and returns the same state object.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from uncrtaints_tpu_torch.config import Config
from uncrtaints_tpu_torch.data.preprocess import process_MS_device
from uncrtaints_tpu_torch.losses import calc_loss, get_loss
from uncrtaints_tpu_torch.models.registry import mean_vars_idx
from uncrtaints_tpu_torch.parallel import mesh


def batch_to_device(batch: Dict, device, non_blocking: bool = False) -> Dict:
    """numpy batch (collate output) -> tensors on ``device``. Arrays keep
    their dtype, raw uint16 DN codes included; other values pass as they
    are. ``non_blocking`` (a CUDA device only) stages each array in pinned
    host memory and enqueues its copy on the current stream without waiting
    for it: the caller orders the stream that reads the tensors behind the
    copy (``train/loop.py`` does, on a side stream)."""
    def to(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if non_blocking:
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    return {k: to(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


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


def eval_forward(cfg: Config, model: torch.nn.Module, x_scaled: torch.Tensor,
                 dates: Optional[torch.Tensor]):
    """The eval forward both serving entry points share (the eval step and
    ``infer.predict_scene``): parameters and the scale_by-scaled input in
    the compute dtype, the output split into fp32 (mean, variance or None),
    still in scaled units. The caller holds ``torch.inference_mode()`` and
    has the model in eval mode."""
    params, xc = _cast_for_forward(cfg, model, x_scaled)
    out = functional_call(model, params, (xc,), {"batch_positions": dates})
    return _split_out(out.float(), cfg)


def profile_flops(cfg: Config, model: torch.nn.Module, batch: Dict) -> float:
    """MFLOP per input sample of the eval forward (the JAX package's
    ``profile_flops``, engine.py:326, reads XLA's cost analysis; the
    reference runs fvcore under ``--profile``). Counted by
    ``torch.utils.flop_counter.FlopCounterMode``: matrix products and
    convolutions at two FLOPs a multiply-add, and the hand-written kernels
    by the formulas registered beside their operators (K3's GEMM, K4's nine
    taps, K1's T products), so a forward through the kernels counts what
    the same forward through the plain layers counts. Elementwise work is
    not counted. ``batch`` holds tensors on the model's device."""
    from torch.utils.flop_counter import FlopCounterMode
    x, _, _ = _prepare_xy(cfg, batch)
    model.eval()
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        eval_forward(cfg, model, x, batch.get("dates"))
    mflops = counter.get_total_flops() * 1e-6 / x.shape[0]
    print(f"MFLOP count: {mflops}")
    return mflops


def make_eval_step(cfg: Config, with_metrics: bool = False,
                   rescale_method: str = "default",
                   return_outputs: bool = True) -> Callable:
    """Build ``eval_step(model, batch) -> {'loss', 'pred', 'var',
    'metrics'}`` (the reference's val/test branch).

    ``batch`` holds tensors on the model's device (:func:`batch_to_device`).
    The step runs under ``torch.inference_mode()`` with the model in eval
    mode. ``pred`` and ``var`` are rescaled to data units (mean / scale_by,
    variance / scale_by^2); ``with_metrics`` adds {name: [B]} image metrics;
    ``return_outputs=False`` (with metrics only) leaves pred and var out.

    Under a spatial split (a 2-D mesh, parallel/mesh.py) ``batch`` holds
    this rank's band of rows of its samples (``shard_batch``): pred and var
    are the band's, the loss and the metrics the whole samples', the same
    on every rank of the spatial group."""
    if not return_outputs and not with_metrics:
        raise ValueError("return_outputs=False requires with_metrics=True "
                         "(the step would compute nothing observable)")
    criterion = get_loss(cfg)
    s = cfg.scale_by

    @torch.inference_mode()
    def eval_step(model: torch.nn.Module, batch: Dict) -> Dict:
        model.eval()
        x, y, y_u = _prepare_xy(cfg, batch, rescale_method)
        mean, var = eval_forward(cfg, model, x, batch.get("dates"))
        loss, variance = calc_loss(criterion, cfg, mean, y, var=var)
        sp = mesh.spatial()
        if sp is not None:  # the mean over the scenes' pixels (even bands)
            loss = mesh.spatial_sum(loss, sp) / sp.n_spatial
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


# --------------------------------------------------------------- training --

@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState over a dict of parameters: the update count
    and the fp32 first and second moments, by parameter name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) written out over
    a list of tensors, with the learning rate as a plain attribute (the
    JAX package injects it as a hyperparameter to set it per epoch):

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  count += 1
        u  = -lr * (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)
        p += u * mask

    The moments update for every parameter, frozen ones too; the 0/1 freeze
    mask multiplies only the update (optax plus the JAX step's mask). The
    elementwise passes are PyTorch's multi-tensor ``_foreach`` ops, a few
    launches for all parameters together."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32,
                                             memory_format=torch.preserve_format)
                         for n, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def step_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, names: Sequence[str],
              mask: Optional[Sequence[float]] = None) -> None:
        """Update ``params`` (in the order of ``names``) and ``state`` in
        place with fp32 ``grads``."""
        b1, b2 = self.b1, self.b2
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - b2))
        state.count += 1
        # optax computes the bias corrections in fp32
        bc1 = float(1.0 - np.float32(b1) ** np.float32(state.count))
        bc2 = float(1.0 - np.float32(b2) ** np.float32(state.count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(upd, -self.lr)
        if mask is not None:
            torch._foreach_mul_(upd, list(mask))
        torch._foreach_add_(list(params), upd)


@dataclasses.dataclass
class TrainState:
    """The port's counterpart of the JAX TrainState: the model (its fp32
    master parameters and batch-norm statistics), the optimizer and its
    state, the step count and the freeze mask ({parameter name: 0.0 or 1.0},
    or None to train everything)."""
    model: torch.nn.Module
    tx: Adam
    opt_state: AdamState
    step: int = 0
    freeze_mask: Optional[Dict[str, float]] = None


def make_optimizer(lr: float) -> Adam:
    """Adam with PyTorch's default hyperparameters; lr settable per epoch."""
    return Adam(lr, b1=0.9, b2=0.999, eps=1e-8)


def epoch_lr(cfg: Config, epoch: int) -> float:
    """ExponentialLR: lr * gamma^epoch, epoch counting completed epochs."""
    return cfg.lr * cfg.gamma ** epoch


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    state.tx.lr = float(lr)
    return state


def create_train_state(cfg: Config, model: torch.nn.Module) -> TrainState:
    """A fresh train state for ``model`` (built by ``get_generator``): Adam
    at ``cfg.lr``, zero moments, step 0, no freeze mask."""
    tx = make_optimizer(cfg.lr)
    return TrainState(model=model, tx=tx,
                      opt_state=tx.init(dict(model.named_parameters())))


def make_train_step(cfg: Config, rescale_method: str = "default") -> Callable:
    """Build ``train_step(state, batch, generator) -> (state, aux)`` with
    aux = {loss, pred, var, grads}: pred and var rescaled to data units
    (mean / scale_by, variance / scale_by^2), grads {parameter name: the
    fp32 gradient the update used}.

    ``batch`` holds tensors on the model's device in either batch form
    (:func:`batch_to_device`); ``generator`` is the ``torch.Generator`` (on
    that device) the attention dropout draws from (the JAX step's
    ``dropout_rng``). The step runs the model in train mode: batch norms
    use and update their batch statistics. The forward runs in the compute
    dtype; the gradients of the fp32 master parameters are fp32.

    ``cfg.accum_steps = k > 1`` splits the batch into k microbatches, runs
    forward and backward on each in order (the batch-norm statistics update
    per microbatch, the dropout generator advances), and applies ONE update
    with the mean of their fp32 gradients; the loss is the mean of the
    microbatch losses.

    Under data parallel (a process group initialised, parallel/mesh.py)
    ``batch`` holds this rank's rows of the global batch (on a 2-D mesh,
    its band of rows of its samples): each rank weighs its loss by its
    share of the global pixels, the gradients and the loss are summed over
    the ranks in one all-reduce before Adam, and the batch norms take the
    global batch's statistics; so every rank makes the update of the global
    batch's mean loss, and the returned loss is that loss. (Weighing by
    rows would count each sample once a band.)"""
    criterion = get_loss(cfg)
    s = cfg.scale_by
    k = max(1, int(getattr(cfg, "accum_steps", 1) or 1))

    def forward_backward(model, masters, x, y, dates, generator, weight=None):
        params, xc = _cast_for_forward(cfg, model, x)
        out = functional_call(model, params, (xc,),
                              {"batch_positions": dates,
                               "dropout_generator": generator})
        mean, var = _split_out(out.float(), cfg)
        loss, variance = calc_loss(criterion, cfg, mean, y, var=var)
        if weight is not None:  # this rank's share of the global mean loss
            loss = loss * weight
        grads = list(torch.autograd.grad(loss, masters))
        variance = variance.detach() if variance is not None else None
        return loss.detach(), grads, mean.detach(), variance

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        x, y, _ = _prepare_xy(cfg, batch, rescale_method)
        dates = batch.get("dates")
        names, masters = map(list, zip(*model.named_parameters()))
        B = x.shape[0]
        if B % k:
            raise ValueError(f"batch {B} not divisible by accum_steps {k}")
        m = B // k
        weight = None
        if mesh.active():
            # data parallel: each rank's microbatch losses weigh by its share
            # of the global pixels (rows x the band's pixels), so that the
            # summed gradient is the global mean loss's, an uneven split and
            # a spatial split included
            pix = y.shape[-3] * y.shape[-2]
            total = mesh.all_reduce_sum(torch.full((1,), float(B * pix), device=x.device))
            weight = (B / k * pix) / total
        grads: List[torch.Tensor] = []
        losses, means, variances = [], [], []
        for i in range(k):  # one microbatch unless accumulating
            sl = slice(i * m, (i + 1) * m)
            l_i, g_i, mean_i, var_i = forward_backward(
                model, masters, x[sl], y[sl], None if dates is None else dates[sl],
                generator, weight)
            if grads:
                torch._foreach_add_(grads, g_i)
            else:
                grads = g_i
            losses.append(l_i)
            means.append(mean_i)
            variances.append(var_i)
        if weight is None:
            torch._foreach_div_(grads, float(k))
            loss = torch.stack(losses).mean()
        else:  # one all-reduce of the flattened gradients and the loss
            flat = mesh.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]
                                                 + [torch.stack(losses).sum().reshape(1)]))
            grads = [f.view_as(g) for f, g in zip(flat[:-1].split([g.numel() for g in grads]),
                                                  grads)]
            loss = flat[-1]
        mean = torch.cat(means)
        variance = None if variances[0] is None else torch.cat(variances)

        mask = None
        if state.freeze_mask is not None:
            mask = [float(state.freeze_mask[n]) for n in names]
        state.tx.step_(masters, grads, state.opt_state, names, mask)
        state.step += 1
        aux = {"loss": loss, "pred": mean / s}
        if variance is not None:
            aux["var"] = variance / (s * s)
        aux["grads"] = dict(zip(names, grads))
        return state, aux

    return train_step
