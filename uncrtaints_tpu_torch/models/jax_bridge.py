"""JAX variables -> the port's state_dict (reference PyTorch names).

The inverse of uncrtaints_tpu/models/torch_import.py:uncrtaints_mapping for
the architecture the port builds (MBConv blocks, tiny L-TAE, shared output
head). Pure numpy: the module imports neither JAX nor that module (which
does); the tests hold the two tables against each other.

Inverse layout transforms: conv HWIO -> OIHW, Dense [I,O] -> Linear [O,I],
Dense [I,O] -> Conv1d [O,I,1]; batch stats mean/var -> running_mean/var.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch


def _conv_w(w):   # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _lin_w(w):    # [I,O] -> [O,I]
    return np.transpose(w)


def _conv1d_w(w):  # [I,O] -> [O,I,1]
    return np.transpose(w)[..., None]


def _ident(w):
    return w


def jax_to_torch_names(cfg) -> Dict[str, Tuple[str, Callable]]:
    """flax path ('B:' prefix for batch_stats) -> (torch name, transform)."""
    m: Dict[str, Tuple[str, Callable]] = {}

    def conv(fp, tp, bias=True):
        m[f"{fp}/kernel"] = (f"{tp}.weight", _conv_w)
        if bias:
            m[f"{fp}/bias"] = (f"{tp}.bias", _ident)

    def norm(fp, tp, batch=False):
        m[f"{fp}/scale"] = (f"{tp}.weight", _ident)
        m[f"{fp}/bias"] = (f"{tp}.bias", _ident)
        if batch:
            m[f"B:{fp}/mean"] = (f"{tp}.running_mean", _ident)
            m[f"B:{fp}/var"] = (f"{tp}.running_var", _ident)

    def norm2d(parent, idx, tp, kind):
        if kind in ("batch", "group"):
            norm(f"{parent}/Norm2d_{idx}", tp, batch=kind == "batch")

    def mbconv(fp, tp, kind):
        norm2d(fp, 0, f"{tp}.conv.norm", kind)
        conv(f"{fp}/Conv2d_0", f"{tp}.conv.fn.0", bias=False)
        norm2d(fp, 1, f"{tp}.conv.fn.1", kind)
        conv(f"{fp}/Conv2d_1", f"{tp}.conv.fn.3", bias=False)
        norm2d(fp, 2, f"{tp}.conv.fn.4", kind)
        m[f"{fp}/SE_0/Dense_0/kernel"] = (f"{tp}.conv.fn.6.fc.0.weight", _lin_w)
        m[f"{fp}/SE_0/Dense_1/kernel"] = (f"{tp}.conv.fn.6.fc.2.weight", _lin_w)
        conv(f"{fp}/Conv2d_2", f"{tp}.conv.fn.7", bias=False)
        norm2d(fp, 3, f"{tp}.conv.fn.8", kind)

    conv("in_conv/ConvLayer_0/Conv2d_0", "in_conv.conv.conv.0")
    norm2d("in_conv/ConvLayer_0", 0, "in_conv.conv.conv.1", cfg.encoder_norm)
    for i in range(len(cfg.encoder_widths)):
        mbconv(f"in_block{i}", f"in_block.{i}", cfg.encoder_norm)
    if not cfg.pretrain:
        te = "temporal_encoder"
        norm(f"{te}/GroupNormCT_0", f"{te}.in_norm")
        m[f"{te}/inconv/kernel"] = (f"{te}.inconv.weight", _conv1d_w)
        m[f"{te}/inconv/bias"] = (f"{te}.inconv.bias", _ident)
        m[f"{te}/Q"] = (f"{te}.attention_heads.Q", _ident)
        m[f"{te}/fc1_k/kernel"] = (f"{te}.attention_heads.fc1_k.weight", _lin_w)
        m[f"{te}/fc1_k/bias"] = (f"{te}.attention_heads.fc1_k.bias", _ident)
    for i in range(len(cfg.decoder_widths)):
        mbconv(f"out_block{i}", f"out_block.{i}", cfg.decoder_norm)
    conv("out_conv/ConvLayer_0/Conv2d_0", "out_conv.conv.conv.0")
    return m


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def from_jax_variables(variables_np: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested mappings of arrays (JAX
    arrays or numpy) -> a state_dict for ``get_generator(cfg)`` that loads
    with ``strict=True``. Raises if a path of the table is missing from the
    variables or a variable has no entry in the table."""
    flat = _flatten(variables_np.get("params", {}))
    flat.update({f"B:{p}": a for p, a in
                 _flatten(variables_np.get("batch_stats", {})).items()})
    table = jax_to_torch_names(cfg)
    missing = sorted(set(table) - set(flat))
    unknown = sorted(set(flat) - set(table))
    if missing or unknown:
        raise KeyError(f"JAX variables do not match the port's table: missing "
                       f"{missing[:5]}, unknown {unknown[:5]}")
    return {tname: torch.from_numpy(
                np.ascontiguousarray(tf(flat[fp]).astype(np.float32)))
            for fp, (tname, tf) in table.items()}
