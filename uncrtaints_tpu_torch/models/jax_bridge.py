"""JAX variables <-> the port's state_dict (reference PyTorch names).

The inverse of the tables of uncrtaints_tpu/models/torch_import.py for every
model the port builds: ``uncrtaints_mapping`` (MBConv or residual blocks,
the tiny or the full L-TAE with ``include_v``, the shared or the separate
output heads), ``unet_mapping``, ``utae_mapping``, ``unet3d_mapping``,
``recunet_mapping`` and ``fpn_mapping``; and tables of the port's own for
the two segmentation-head models (``convlstm``, ``convgru``), which that file
does not map, and for MBConv's ``expansion == 1`` and ``downsample``
variants. Pure numpy: the module imports neither JAX nor that module (which
does); the tests hold each table against its forward table.

Inverse layout transforms: conv HWIO -> OIHW, Dense [I,O] -> Linear [O,I],
Dense [I,O] -> Conv1d [O,I,1], a transposed conv's spatially flipped HWIO ->
[I,O,kh,kw] (flipped back), 3-D kernels likewise; batch stats mean/var ->
running_mean/var. :func:`to_jax_variables` undoes each of them, so a state
dict goes back to the JAX package's variables (train/checkpoint.py writes
the JAX package's ``.ckpt`` with it); Adam's moments are elementwise and
take the parameters' table both ways (:func:`params_table`). Every leaf
keeps its dtype, so the two directions are bit-equal.

:func:`_migrate_legacy_conv_paths` is a copy of the JAX package's
(train/checkpoint.py there): it reads trees of the JAX package's older
``.ckpt`` files.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from uncrtaints_tpu_torch.train.flax_format import from_tensor, to_tensor

Table = Dict[str, Tuple[str, Callable]]


def _conv_w(w):   # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _lin_w(w):    # [I,O] -> [O,I]
    return np.transpose(w)


def _conv1d_w(w):  # [I,O] -> [O,I,1]
    return np.transpose(w)[..., None]


def _conv_t_w(w):  # flipped HWIO -> ConvTranspose2d [I,O,kh,kw]
    return np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _conv3d_w(w):  # [kt,kh,kw,I,O] -> [O,I,kt,kh,kw]
    return np.transpose(w, (4, 3, 0, 1, 2))


def _conv_t3d_w(w):  # flipped [kt,kh,kw,I,O] -> ConvTranspose3d [I,O,kt,kh,kw]
    return np.transpose(w, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


def _ident(w):
    return w


# the inverse of each transform above: the port's layout -> the JAX one
_INVERSE = {
    _conv_w: lambda w: np.transpose(w, (2, 3, 1, 0)),
    _lin_w: np.transpose,
    _conv1d_w: lambda w: np.transpose(w[..., 0]),
    _conv_t_w: lambda w: np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)),
    _conv3d_w: lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    _conv_t3d_w: lambda w: np.transpose(w[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1)),
    _ident: _ident,
}


class _TableMaker:
    """Fills a table: flax path ('B:' prefix for batch_stats) -> (torch
    name, transform)."""

    def __init__(self):
        self.m: Table = {}

    def conv(self, fp, tp, bias=True, tf=_conv_w):
        self.m[f"{fp}/kernel"] = (f"{tp}.weight", tf)
        if bias:
            self.m[f"{fp}/bias"] = (f"{tp}.bias", _ident)

    def norm(self, fp, tp, batch=False):
        self.m[f"{fp}/scale"] = (f"{tp}.weight", _ident)
        self.m[f"{fp}/bias"] = (f"{tp}.bias", _ident)
        if batch:
            self.m[f"B:{fp}/mean"] = (f"{tp}.running_mean", _ident)
            self.m[f"B:{fp}/var"] = (f"{tp}.running_var", _ident)

    def norm2d(self, parent, idx, tp, kind):
        if kind in ("batch", "group"):
            self.norm(f"{parent}/Norm2d_{idx}", tp, batch=kind == "batch")

    def conv_layer(self, fp, tp, kind, n=1):
        """A ConvLayer of n convs: ``{tp}.conv.{3j}`` and its norm at 3j+1."""
        for j in range(n):
            self.conv(f"{fp}/Conv2d_{j}", f"{tp}.conv.{3 * j}")
            self.norm2d(fp, j, f"{tp}.conv.{3 * j + 1}", kind)

    def mbconv(self, fp, tp, kind, expansion=2, downsample=False):
        self.norm2d(fp, 0, f"{tp}.conv.norm", kind)
        if expansion == 1:
            self.conv(f"{fp}/Conv2d_0", f"{tp}.conv.fn.0", bias=False)   # dw
            self.norm2d(fp, 1, f"{tp}.conv.fn.1", kind)
            self.conv(f"{fp}/Conv2d_1", f"{tp}.conv.fn.3", bias=False)   # pw-linear
            self.norm2d(fp, 2, f"{tp}.conv.fn.4", kind)
            n_conv = 2
        else:
            self.conv(f"{fp}/Conv2d_0", f"{tp}.conv.fn.0", bias=False)   # pw
            self.norm2d(fp, 1, f"{tp}.conv.fn.1", kind)
            self.conv(f"{fp}/Conv2d_1", f"{tp}.conv.fn.3", bias=False)   # dw
            self.norm2d(fp, 2, f"{tp}.conv.fn.4", kind)
            self.m[f"{fp}/SE_0/Dense_0/kernel"] = (f"{tp}.conv.fn.6.fc.0.weight", _lin_w)
            self.m[f"{fp}/SE_0/Dense_1/kernel"] = (f"{tp}.conv.fn.6.fc.2.weight", _lin_w)
            self.conv(f"{fp}/Conv2d_2", f"{tp}.conv.fn.7", bias=False)   # pw-linear
            self.norm2d(fp, 3, f"{tp}.conv.fn.8", kind)
            n_conv = 3
        if downsample:
            self.conv(f"{fp}/Conv2d_{n_conv}", f"{tp}.proj", bias=False)

    def residual(self, fp, tp, kind):
        for j in range(3):
            self.conv_layer(f"{fp}/ConvLayer_{j}", f"{tp}.conv{j + 1}", kind)

    def ltae(self, te, in_norm, full):
        self.norm(f"{te}/{in_norm}", f"{te}.in_norm")
        self.m[f"{te}/inconv/kernel"] = (f"{te}.inconv.weight", _conv1d_w)
        self.m[f"{te}/inconv/bias"] = (f"{te}.inconv.bias", _ident)
        self.m[f"{te}/Q"] = (f"{te}.attention_heads.Q", _ident)
        self.m[f"{te}/fc1_k/kernel"] = (f"{te}.attention_heads.fc1_k.weight", _lin_w)
        self.m[f"{te}/fc1_k/bias"] = (f"{te}.attention_heads.fc1_k.bias", _ident)
        if full:  # one MLP stage (d_model -> width), the output norm
            self.m[f"{te}/Dense_0/kernel"] = (f"{te}.mlp.0.weight", _lin_w)
            self.m[f"{te}/Dense_0/bias"] = (f"{te}.mlp.0.bias", _ident)
            self.norm(f"{te}/BatchNorm_0", f"{te}.mlp.1", batch=True)
            self.norm(f"{te}/out_norm", f"{te}.out_norm")

    def unet_stages(self, n, enc, dec):
        """in_conv, the n-1 down and up blocks and out_conv of a U-Net whose
        in_conv is one 1x1 conv."""
        self.conv_layer("in_conv/ConvLayer_0", "in_conv.conv", enc)
        self.down_blocks(n, enc)
        self.up_blocks(n, dec)
        self.conv("out_conv/ConvLayer_0/Conv2d_0", "out_conv.conv.conv.0")

    def down_blocks(self, n, kind):
        for i in range(n - 1):
            for j, sub in enumerate(("down", "conv1", "conv2")):
                self.conv_layer(f"down_block{i}/ConvLayer_{j}", f"down_blocks.{i}.{sub}", kind)

    def up_blocks(self, n, kind):
        for i in range(n - 1):
            ub, tb = f"up_block{i}", f"up_blocks.{i}"
            self.conv(f"{ub}/Conv2d_0", f"{tb}.skip_conv.0")
            self.norm(f"{ub}/Norm2d_0", f"{tb}.skip_conv.1", batch=True)
            self.conv(f"{ub}/ConvTranspose_0", f"{tb}.up.0", tf=_conv_t_w)
            self.norm(f"{ub}/Norm2d_1", f"{tb}.up.1", batch=True)
            self.conv_layer(f"{ub}/ConvLayer_0", f"{tb}.conv1", kind)
            self.conv_layer(f"{ub}/ConvLayer_1", f"{tb}.conv2", kind)

    def convlstm(self, fp, tp):
        self.conv(f"{fp}/cell/gates", f"{tp}.cell_list.0.conv")


def _uncrtaints(t: _TableMaker, cfg):
    block = t.mbconv if cfg.block_type == "mbconv" else t.residual
    t.conv_layer("in_conv/ConvLayer_0", "in_conv.conv", cfg.encoder_norm)
    for i in range(len(cfg.encoder_widths)):
        block(f"in_block{i}", f"in_block.{i}", cfg.encoder_norm)
    if not cfg.pretrain:
        te = "temporal_encoder"
        t.ltae(te, "in_norm" if cfg.use_v else "GroupNormCT_0", full=cfg.use_v)
        if cfg.use_v:
            t.conv("include_v", "include_v")
    for i in range(len(cfg.decoder_widths)):
        block(f"out_block{i}", f"out_block.{i}", cfg.decoder_norm)
    if cfg.separate_out:
        t.conv("out_conv_mean_1/ConvLayer_0/Conv2d_0", "out_conv_mean_1.conv.conv.0")
        if cfg.out_conv[-1] - 13 > 0:  # else a mean-only head
            t.conv("out_conv_var_1/ConvLayer_0/Conv2d_0", "out_conv_var_1.conv.conv.0")
    else:
        t.conv("out_conv/ConvLayer_0/Conv2d_0", "out_conv.conv.conv.0")


def _unet3d(t: _TableMaker):
    def bn3d(fp, tp):
        t.norm(f"{fp}/BatchNorm_0", tp, batch=True)

    for blk in ("en3", "en4", "dc4", "dc3"):
        for j in range(2):
            t.conv(f"{blk}/Conv_{j}", f"{blk}.{3 * j}", tf=_conv3d_w)
            bn3d(f"{blk}/BatchNorm3d_{j}", f"{blk}.{3 * j + 1}")
    t.conv("center_in", "center_in.0", tf=_conv3d_w)
    bn3d("BatchNorm3d_0", "center_in.1")
    t.conv("Conv_0", "center_out.0", tf=_conv3d_w)
    bn3d("BatchNorm3d_1", "center_out.1")
    t.conv("center_out", "center_out.3", tf=_conv_t3d_w)
    t.conv("trans3", "trans3.0", tf=_conv_t3d_w)
    bn3d("BatchNorm3d_2", "trans3.1")
    t.conv("final", "final", tf=_conv3d_w)


def _recunet(t: _TableMaker, temporal: str, n: int = 4, kind: str = "group"):
    """RecUNet at build_recurrent's widths (four stages): a two-conv in_conv,
    group norms in the blocks, batch-norm skip, up and out_conv norms."""
    t.conv_layer("in_conv/ConvLayer_0", "in_conv.conv", kind, n=2)
    t.down_blocks(n, kind)
    if temporal == "lstm":
        t.convlstm("temporal_encoder", "temporal_encoder")
    elif temporal == "blstm":  # the port's names, not torch_import's (recurrent.py)
        for ours in ("forward", "backward"):
            t.convlstm(f"temporal_encoder/{ours}", f"temporal_encoder.convlstm_{ours}")
    if temporal in ("lstm", "blstm"):
        t.conv("out_convlstm", "out_convlstm")
    t.up_blocks(n, kind)
    t.conv_layer("out_conv/ConvLayer_0", "out_conv.conv", "batch")


def _fpn(t: _TableMaker, n_levels: int = 5):
    t.conv_layer("inconv/ConvLayer_0", "inconv.conv", "group", n=2)
    t.conv("pyramid/inconv", "pyramid.inconv")
    for i in range(n_levels - 1):
        t.conv(f"pyramid/dil{i}", f"pyramid.convs.{i}")
    t.conv_layer("mid_conv/ConvLayer_0", "mid_conv.conv", "group")
    t.convlstm("convlstm", "convlstm")
    t.conv("outconv", "outconv")


def _seg(t: _TableMaker, model: str):
    if model == "convlstm":
        t.convlstm("convlstm_encoder", "convlstm_encoder")
    else:
        for conv in ("in_conv", "out_conv"):
            t.conv(f"convgru_encoder/cell/{conv}", f"convgru_encoder.cell_list.0.{conv}")
    t.conv("classification_layer", "classification_layer")


def jax_to_torch_names(cfg) -> Table:
    """flax path ('B:' prefix for batch_stats) -> (torch name, transform)
    for the model ``get_generator(cfg)`` builds."""
    t, model = _TableMaker(), cfg.model
    n = len(cfg.encoder_widths)
    if model == "uncrtaints":
        _uncrtaints(t, cfg)
    elif "unet3d" in model:
        _unet3d(t)
    elif "unet" in model or (model == "utae" and cfg.pretrain):
        t.unet_stages(n, cfg.encoder_norm, cfg.decoder_norm)
    elif "utae" in model:
        t.unet_stages(n, cfg.encoder_norm, cfg.decoder_norm)
        t.ltae("temporal_encoder", "in_norm", full=True)
    elif model in ("uconvlstm", "buconvlstm"):
        _recunet(t, "lstm" if model == "uconvlstm" else "blstm")
    elif model == "fpn":
        _fpn(t)
    elif model in ("convlstm", "convgru"):
        _seg(t, model)
    else:
        raise NotImplementedError(model)
    return t.m


def mbconv_names(kind: str, expansion: int, downsample: bool) -> Table:
    """The table of one MBConv block at the root (its flax variables as
    ``MBConv(...).init`` returns them)."""
    t = _TableMaker()
    t.mbconv("", "", kind, expansion, downsample)
    return {k.lstrip("/").replace("B:/", "B:"): (v[0].lstrip("."), v[1])
            for k, v in t.m.items()}


def params_table(table: Table) -> Table:
    """The parameters' part of a table (no batch statistics): the table of
    a tree shaped like ``params``, as Adam's moments are."""
    return {k: v for k, v in table.items() if not k.startswith("B:")}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asanyarray(v)
    return flat


def from_table(variables_np: Mapping, table: Table,
               strict: bool = True) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested mappings of arrays (JAX
    arrays or numpy) -> a state_dict by ``table``, each tensor in its
    leaf's dtype. Raises if a path of the table is missing from the
    variables or a variable has no entry in it; with ``strict=False`` maps
    the paths the two share and leaves out the rest."""
    flat = _flatten(variables_np.get("params", {}))
    flat.update({f"B:{p}": a for p, a in
                 _flatten(variables_np.get("batch_stats", {})).items()})
    missing = sorted(set(table) - set(flat))
    unknown = sorted(set(flat) - set(table))
    if strict and (missing or unknown):
        raise KeyError(f"JAX variables do not match the port's table: missing "
                       f"{missing[:5]}, unknown {unknown[:5]}")
    return {tname: to_tensor(tf(flat[fp])) for fp, (tname, tf) in table.items()
            if fp in flat}


def _sorted_tree(tree: Dict) -> Dict:
    """Keys in sorted order at every level, as JAX's trees hold them."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def to_table(state_dict: Mapping[str, torch.Tensor], table: Table) -> Dict[str, Dict]:
    """The inverse of :func:`from_table`: a state_dict -> {'params': ...,
    'batch_stats': ...} nested dicts of numpy arrays in the tensors' dtypes
    (bf16 as ``flax_format.BFloat16``), keys sorted at every level. Raises
    if a name of the table is missing from the state_dict or a tensor has
    no entry in it."""
    names = {tname for tname, _ in table.values()}
    missing = sorted(names - set(state_dict))
    unknown = sorted(set(state_dict) - names)
    if missing or unknown:
        raise KeyError(f"the state_dict does not match the port's table: missing "
                       f"{missing[:5]}, unknown {unknown[:5]}")
    out = {"params": {}, "batch_stats": {}}
    for fp, (tname, tf) in table.items():
        leaf = np.array(_INVERSE[tf](from_tensor(state_dict[tname])), order="C", subok=True)
        node = out["batch_stats"] if fp.startswith("B:") else out["params"]
        *parents, last = fp.removeprefix("B:").split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return {k: _sorted_tree(v) for k, v in out.items()}


def from_jax_variables(variables_np: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX variables of ``cfg``'s model -> a state_dict for
    ``get_generator(cfg)`` that loads with ``strict=True``."""
    return from_table(variables_np, jax_to_torch_names(cfg))


def to_jax_variables(state_dict: Mapping[str, torch.Tensor], cfg) -> Dict[str, Dict]:
    """The inverse of :func:`from_jax_variables`: the state_dict of
    ``get_generator(cfg)`` -> its JAX variables {'params', 'batch_stats'}
    (an empty ``batch_stats`` for a model without batch norm)."""
    return to_table(state_dict, jax_to_torch_names(cfg))


def _migrate_legacy_conv_paths(tree):
    """Lift legacy ``.../Conv2d_i/Conv_0/{kernel,bias}`` nodes one level up.

    Early checkpoints were written when Conv2d wrapped ``nn.Conv`` (param
    path ``Conv2d_i/Conv_0/kernel``); Conv2d now owns its kernel/bias
    directly. Applied recursively, so optimizer-state copies of the param
    tree migrate too."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        v = _migrate_legacy_conv_paths(v)
        # Restrict the lift to the known legacy wrapper shape: parent key
        # from the Conv2d wrapper family AND the Conv_0 node holding exactly
        # conv leaves {kernel[, bias]}. A module that legitimately contains
        # a single nn.Conv child named Conv_0 must NOT be restructured.
        if (isinstance(v, dict) and set(v) == {"Conv_0"}
                and isinstance(v["Conv_0"], dict)
                and k.split("_")[0] == "Conv2d"
                and set(v["Conv_0"]) in ({"kernel"}, {"kernel", "bias"})):
            v = v["Conv_0"]
        out[k] = v
    return out
