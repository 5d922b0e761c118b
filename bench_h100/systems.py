"""The systems a cell can drive, behind one interface.

:class:`PortEval` and :class:`PortTrain` are the system under test: the
PyTorch port ``uncrtaints_tpu_torch`` through its public entry points only
(``config.derive``, ``models.registry.get_generator``,
``train.engine.make_eval_step`` / ``make_train_step`` with
``create_train_state``). :class:`ReferenceEval` and
:class:`ReferenceTrain` put the plain reference in the program's place, in
the precision ``q`` gives: the control that the correctness check must
refuse.

Eval systems map a batch to {"pred", "var", "loss"} (pred and var in data
units); train systems run one step on a batch with the dropout generator
and return its {"loss", "pred"}, and expose the parameters and Adam's first
moment.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Callable, Dict

import torch

from bench_h100.reference import common


def port_config(cfgfile: dict, batch: int, device: torch.device):
    """The port's derived Config for this configuration file at ``batch``;
    it must agree with the file's explicit model description."""
    from uncrtaints_tpu_torch.config import Config, derive, input_dim
    cfg = derive(Config(**cfgfile["port"], batch_size=batch, device=str(device)))
    m = cfgfile["model"]
    got = {"input_dim": input_dim(cfg), "encoder_widths": list(cfg.encoder_widths),
           "decoder_widths": list(cfg.decoder_widths), "out_channels": cfg.out_conv[-1],
           "n_head": cfg.n_head, "d_model": cfg.d_model, "d_k": cfg.d_k, "loss": cfg.loss,
           "scale_by": cfg.scale_by, "input_t": cfg.input_t}
    bad = {k: (v, m[k]) for k, v in got.items() if m.get(k) != v}
    if bad:
        raise ValueError(f"{cfgfile['name']}: the port's derived config differs from the "
                         f"configuration file (port, file): {bad}")
    if cfgfile["dtype"] != {"bfloat16": "bfloat16", "float32": "float32"}[cfg.compute_dtype]:
        raise ValueError(f"{cfgfile['name']}: dtype {cfgfile['dtype']} but the port "
                         f"computes in {cfg.compute_dtype}")
    return cfg


def port_model(cfg, device: torch.device, seed: int):
    """The port's model for ``cfg``, built on ``device`` (its own init draws
    on the device; the benchmark's weights replace them)."""
    from uncrtaints_tpu_torch.models.registry import get_generator
    gen = torch.Generator(device=device if device.type != "meta" else "cpu").manual_seed(seed)
    with torch.device(device):
        return get_generator(cfg, device=device, generator=gen)


def state_shapes(cfgfile: dict, batch: int, device: torch.device) -> Dict[str, torch.Size]:
    """Names and shapes of the port's state_dict for this configuration
    (built on the meta device: no memory, no draws)."""
    cfg = port_config(cfgfile, batch, torch.device("meta"))
    return {k: v.shape for k, v in port_model(cfg, torch.device("meta"), 0).state_dict().items()}


class PortEval:
    kind = "eval"

    def __init__(self, cfgfile: dict, batch: int, weights: Dict[str, torch.Tensor],
                 device: torch.device, seed: int):
        from uncrtaints_tpu_torch.train.engine import make_eval_step
        cfg = port_config(cfgfile, batch, device)
        self.model = port_model(cfg, device, seed)
        self.model.load_state_dict(weights)
        self.step = make_eval_step(cfg)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.step(self.model, batch)


class PortTrain:
    kind = "train"

    def __init__(self, cfgfile: dict, batch: int, weights: Dict[str, torch.Tensor],
                 device: torch.device, seed: int):
        from uncrtaints_tpu_torch.train.engine import create_train_state, make_train_step
        cfg = port_config(cfgfile, batch, device)
        model = port_model(cfg, device, seed)
        model.load_state_dict(weights)
        self.state = create_train_state(cfg, model)
        self.step = make_train_step(cfg)

    def __call__(self, batch: Dict[str, torch.Tensor], gen: torch.Generator):
        _, aux = self.step(self.state, batch, gen)
        return {"loss": aux["loss"], "pred": aux["pred"]}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.state.model.named_parameters()}

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.opt_state.mu)


REFERENCE = Path(__file__).resolve().parent / "reference"


def family(cfgfile: dict):
    """The reference family module the configuration names:
    ``reference/<family>.py`` of the cell's benchmark folder
    (``cfgfile["reference_dir"]``, which harness.cell_spec sets) or of this
    one."""
    path = Path(cfgfile.get("reference_dir", REFERENCE)) / f"{cfgfile['family']}.py"
    name = f"bench_h100.reference.{cfgfile['family']}"
    mod = sys.modules.get(name)
    if mod is None or Path(mod.__file__).resolve() != path.resolve():
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def reference_outputs(cfgfile: dict, P, batch, train: bool, drop=common.no_dropout,
                      q: Callable = common.exact):
    """(loss, pred, var) of the reference on ``batch`` in data units."""
    m = cfgfile["model"]
    s = m["scale_by"]
    mean, var = family(cfgfile).forward(P, s * batch["x"].float(), batch["dates"], m, train,
                                        drop=drop, q=q)
    loss = common.loss(m, mean, var, s * batch["y"].float())
    return loss, mean / s, None if var is None else var / (s * s)


class ReferenceEval:
    """The reference in the program's place (the control): eval outputs in
    the precision ``q``."""
    kind = "eval"

    def __init__(self, cfgfile: dict, weights, q=common.fp8_e4m3):
        self.cfgfile, self.P, self.q = cfgfile, {k: v.float() for k, v in weights.items()}, q

    @torch.no_grad()
    def __call__(self, batch):
        loss, pred, var = reference_outputs(self.cfgfile, self.P, batch, False, q=self.q)
        out = {"loss": loss, "pred": pred}
        if var is not None:
            out["var"] = var
        return out


class ReferenceTrain:
    """The reference in the program's place (the control): train steps in
    the precision ``q``, with the configuration's Adam over every parameter
    (the weights that are not running statistics)."""
    kind = "train"

    def __init__(self, cfgfile: dict, weights, q=common.fp8_e4m3):
        self.cfgfile, self.q = cfgfile, q
        self.P = {k: v.float().clone() for k, v in weights.items()}
        self.names = [n for n in weights if not n.endswith(("running_mean", "running_var"))]
        o = cfgfile["optimizer"]
        self.opt = common.Adam({n: self.P[n] for n in self.names}, o["lr"], o["b1"], o["b2"],
                               o["eps"])

    def __call__(self, batch, gen: torch.Generator):
        leaves = {n: self.P[n].requires_grad_(True) for n in self.names}
        loss, pred, _ = reference_outputs(self.cfgfile, self.P, batch, True,
                                          drop=common.seeded_dropout(gen), q=self.q)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for p in leaves.values():
            p.requires_grad_(False)
        self.opt.step(leaves, dict(zip(self.names, grads)))
        return {"loss": loss.detach(), "pred": pred.detach()}

    def params(self):
        return {n: self.P[n] for n in self.names}

    def first_moment(self):
        return self.opt.mu
