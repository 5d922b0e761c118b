"""Checkpointing: save/restore (model, optimizer state, lr, epoch, step) with
the reference's best / per-epoch / resume semantics.

Port of uncrtaints_tpu/train/checkpoint.py: a per-epoch
``model_epoch_{k}`` plus a best-on-val ``model``; loading restores the
optimizer and the schedule for ``--resume_from`` and supports partial
transfer from a pretrained net with layer freezing.

One format: the reference's ``.pth.tar`` layout, written with ``torch.save``
to ``{res_dir}/{experiment}/{name}.pth.tar``::

    {"epoch": int, "state_dict_G": model.state_dict(), "optimizer_G":
     {"count": int, "mu": {name: tensor}, "nu": {name: tensor}},
     "lr": float, "step": int}

with every tensor on the CPU, so ``torch.load(path, weights_only=True)``
reads it. The JAX package's ``load_checkpoint`` falls through to a file of
this name and layout, so a run trained here can be tested there with no
conversion. ``cfg.ckpt_backend`` "msgpack" (the default) means this
single-file format in this package.

The JAX package's own single-file checkpoint is read too, on every path
that reads one (:func:`load_checkpoint`, :func:`load_pretrained_partial`,
so ``--resume_from``, ``--trained_checkp`` and ``cli.test``): a flax
msgpack blob ``{name}.ckpt`` = {"params", "batch_stats", "opt_state",
"step"} (train/checkpoint.py:54-102 there), beside a ``{name}.meta.json``
of {"epoch", "lr", "step"}. ``train/flax_format.py`` decodes it without
flax; ``models/jax_bridge.py`` maps the variables and Adam's moments
(``opt_state`` is optax's ``inject_hyperparams(adam)`` state) to this
package's names, older trees' ``Conv2d_i/Conv_0`` paths lifted first as
the JAX package lifts them. :func:`save_jax_checkpoint` writes that format
from a state of this package, Adam's state included, for the JAX package
to read; no CLI flag reaches it. The JAX package's ``.orbax`` directories
are not read: orbax writes tensorstore's OCDBT layout (a B-tree of
compressed chunks), which needs tensorstore, and the card's machine has
none. Restore such a run in the JAX package and save it there with
``ckpt_backend="msgpack"``: that ``.ckpt`` reads here.

``cfg.ckpt_backend="orbax"`` is the counterpart of the JAX package's async
orbax checkpoint (train/checkpoint.py:32-90 there): the same blob goes to a
``{name}.dcp/`` directory through ``torch.distributed.checkpoint.async_save``
(into a temporary directory, renamed when the write has landed, the copy it
replaces kept as ``.prev`` until then). The save returns once the blob is
copied to host memory, and training goes on while a background thread
writes it; :func:`wait_for_checkpoints` waits for every pending write, and
:func:`load_checkpoint` calls it before it looks at the disk. The blob is
replicated on every rank, so rank 0 alone writes it (a single-process
save, with or without a process group) and every rank reads it. Load finds
the format from what is on disk, as the JAX package's does: a ``.dcp``
directory (or its ``.prev``) before a ``.pth.tar`` file.

A reference file's running variance of ``LTAE2d``'s ``BatchNorm1d``
(``temporal_encoder.mlp.1.running_var``) is PyTorch's unbiased estimate,
while this package keeps the biased one (as flax does). The value is loaded
as it stands, never rescaled: over the n = B*H*W rows of a training batch
the two differ by the factor n / (n - 1).
"""

from __future__ import annotations

import concurrent.futures
import inspect
import json
import os
import re
import shutil
from typing import Dict, List, Tuple

import numpy as np
import torch

from uncrtaints_tpu_torch.models.jax_bridge import (
    _migrate_legacy_conv_paths, from_table, jax_to_torch_names, params_table, to_table)
from uncrtaints_tpu_torch.train import flax_format
from uncrtaints_tpu_torch.train.engine import TrainState, set_learning_rate


def _ckpt_path(res_dir: str, experiment: str, name: str) -> str:
    return os.path.join(res_dir, experiment, f"{name}.pth.tar")


def _jax_ckpt_path(res_dir: str, experiment: str, name: str) -> str:
    return os.path.join(res_dir, experiment, f"{name}.ckpt")


def _dcp_path(res_dir: str, experiment: str, name: str) -> str:
    return os.path.join(res_dir, experiment, f"{name}.dcp")


# the background writes of ckpt_backend="orbax": one thread commits them in
# the order they were asked for
_PENDING: List[concurrent.futures.Future] = []
_COMMITTER = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="uncr-dcp-commit")


def wait_for_checkpoints() -> None:
    """Block until every pending asynchronous (``.dcp``) save has landed
    under its name, and raise the first error of one that failed. Call it
    before reading a checkpoint just written and before the process exits
    (the CLIs do; :func:`load_checkpoint` does)."""
    while _PENDING:
        _PENDING.pop(0).result()


def _commit(upload, tmp: str, path: str) -> None:
    """Wait for the write into ``tmp``, then put it under ``path``: the copy
    it replaces becomes ``path.prev`` first and goes once the new one is in
    place, so a reader always finds a whole checkpoint under one name."""
    getattr(upload, "upload_completion", upload).result()
    prev = path + ".prev"
    if os.path.isdir(path):
        if os.path.isdir(prev):
            shutil.rmtree(prev)
        os.replace(path, prev)
    os.replace(tmp, path)
    if os.path.isdir(prev):
        shutil.rmtree(prev)


def _single_process(fn) -> Dict:
    """``no_dist=True`` where ``fn`` takes it: this rank reads or writes the
    whole blob alone, whether or not a process group runs."""
    return {"no_dist": True} if "no_dist" in inspect.signature(fn).parameters else {}


def _save_dcp(blob: Dict, path: str) -> None:
    """``torch.distributed.checkpoint.async_save`` of ``blob`` (CPU tensors
    this function owns) into a temporary directory beside ``path``, renamed
    to ``path`` in the background when written. A single-process save: the
    blob is whole on this rank, so no other rank takes part."""
    import torch.distributed.checkpoint as dcp
    tmp = f"{path}.tmp-{os.getpid()}-{len(_PENDING)}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    upload = dcp.async_save(blob, checkpoint_id=tmp, **_single_process(dcp.async_save))
    _PENDING.append(_COMMITTER.submit(_commit, upload, tmp, path))


def _read_dcp(path: str) -> Dict:
    """A ``.dcp`` directory's blob, rebuilt from its metadata: the nested
    layout of :func:`save_checkpoint` (the model's and Adam's dicts by
    parameter name)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else None for k, m in meta.items()}
    dcp.load(flat, checkpoint_id=path, **_single_process(dcp.load))
    blob: Dict = {}
    for k, v in flat.items():
        for prefix in ("state_dict_G.", "optimizer_G.mu.", "optimizer_G.nu."):
            if k.startswith(prefix):
                *outer, inner = prefix[:-1].split(".")
                d = blob
                for part in outer:
                    d = d.setdefault(part, {})
                d.setdefault(inner, {})[k[len(prefix):]] = v
                break
        else:
            head, _, tail = k.partition(".")
            if tail:
                blob.setdefault(head, {})[tail] = v
            else:
                blob[k] = v
    return blob


def _orbax_refusal(path: str) -> ValueError:
    return ValueError(
        f"{path} is the JAX package's checkpoint as an orbax directory (tensorstore's OCDBT "
        "layout), which this package does not read: restore it in the JAX package and save "
        "it there with ckpt_backend='msgpack', a .ckpt file that this package reads")


def _blob_path(checkp_dir: str, experiment: str, name: str) -> str:
    """The checkpoint ``name`` on disk, by what is there (after the pending
    asynchronous saves have landed), this package's own first, so that its
    newer files win in a JAX run directory it resumed: ``{name}.dcp``, else
    its ``.prev`` (a re-save interrupted between its two renames), else
    ``{name}.pth.tar``, else the JAX package's ``{name}.ckpt``. A JAX
    ``.orbax`` alone under that name is refused."""
    wait_for_checkpoints()
    dcp_dir = _dcp_path(checkp_dir, experiment, name)
    for p in (dcp_dir, dcp_dir + ".prev"):
        if os.path.isdir(p):
            return p
    path = _ckpt_path(checkp_dir, experiment, name)
    for p in (path, _jax_ckpt_path(checkp_dir, experiment, name)):
        if os.path.exists(p):
            return p
    orbax = os.path.join(checkp_dir, experiment, name + ".orbax")
    if os.path.exists(orbax):
        raise _orbax_refusal(orbax)
    return path


def normalize_legacy_keys(sd: Dict) -> Dict:
    """in_block1 -> in_block0 etc.: the reference's ModuleList entries are
    ``in_block.{i}`` and legacy checkpoints used 1-based indices (own copy
    of ``normalize_legacy_keys`` in uncrtaints_tpu/models/torch_import.py).
    Here it also drops the ``num_batches_tracked`` counters of a reference
    file, which this package's batch norms do not keep."""
    out = {}
    has_zero = any(re.match(r"(in|out)_block\.0\.", k) for k in sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        m = re.match(r"(in_block|out_block)\.(\d+)\.(.*)", k)
        if m and not has_zero:
            k = f"{m.group(1)}.{int(m.group(2)) - 1}.{m.group(3)}"
        out[k] = v
    return out


def _read_jax(path: str, cfg, strict: bool = True) -> Dict:
    """A JAX ``.ckpt`` and its ``.meta.json`` -> the blob a ``.pth.tar``
    gives: ``state_dict_G`` (params and batch_stats by this package's
    names), ``optimizer_G`` (Adam's count and moments by parameter name,
    and the hyperparameters to check), ``lr`` (the sidecar's, else the
    saved learning rate, as the JAX load falls back to the restored
    hyperparameters), ``step`` and ``epoch`` (1 without a sidecar). With
    ``strict=False`` (partial transfer) only the variables of the file that
    ``cfg``'s model also has are mapped."""
    with open(path, "rb") as f:
        tree = _migrate_legacy_conv_paths(flax_format.restore(f.read()))
    meta_path = path.removesuffix(".ckpt") + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    table = jax_to_torch_names(cfg)
    variables = {"params": tree.get("params", {}), "batch_stats": tree.get("batch_stats", {})}
    blob = {"state_dict_G": from_table(variables, table, strict=strict),
            "step": int(tree.get("step", meta.get("step", 0))),
            "epoch": int(meta.get("epoch", 1))}
    opt = tree.get("opt_state")
    if strict and opt:
        adam = opt["inner_state"]["0"]
        moments = params_table(table)
        blob["optimizer_G"] = {
            "count": int(adam["count"]),
            "mu": from_table({"params": adam["mu"]}, moments),
            "nu": from_table({"params": adam["nu"]}, moments),
            "hyperparams": {k: float(v) for k, v in opt["hyperparams"].items()}}
    if "lr" in meta:
        blob["lr"] = float(meta["lr"])
    elif opt:
        blob["lr"] = float(opt["hyperparams"]["learning_rate"])
    return blob


def _read(path: str, cfg=None, strict: bool = True) -> Tuple[Dict, Dict]:
    """(the blob of a ``.pth.tar`` file, a ``.dcp`` directory or a JAX
    ``.ckpt`` (whose names ``cfg``'s model decides), its normalized model
    state dict)."""
    if path.endswith(".orbax"):
        raise _orbax_refusal(path)
    if path.endswith(".ckpt"):
        blob = _read_jax(path, cfg, strict)
    elif os.path.isdir(path):
        blob = _read_dcp(path)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict_G", blob)
    return blob, normalize_legacy_keys(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


def save_checkpoint(cfg, epoch: int, state: TrainState, name: str,
                    lr: float) -> str:
    """Write the {name} checkpoint (to a temporary name, then renamed, so a
    reader never finds half a file). Returns its path. With
    ``cfg.ckpt_backend == "orbax"`` it is a ``{name}.dcp`` directory written
    in the background (:func:`wait_for_checkpoints`)."""
    orbax = getattr(cfg, "ckpt_backend", "msgpack") == "orbax"
    path = (_dcp_path if orbax else _ckpt_path)(cfg.res_dir, cfg.experiment_name, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # copies, so that training may go on while a background write reads them
    cpu = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
    opt = state.opt_state
    blob = {
        "epoch": int(epoch),
        "state_dict_G": cpu(state.model.state_dict()),
        "optimizer_G": {"count": int(opt.count), "mu": cpu(opt.mu), "nu": cpu(opt.nu)},
        "lr": float(lr),
        "step": int(state.step),
    }
    if orbax:
        _save_dcp(blob, path)
        return path
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_jax_checkpoint(cfg, epoch: int, state: TrainState, name: str, lr: float) -> str:
    """Write the {name} checkpoint in the JAX package's single-file format,
    the counterpart of its msgpack ``save_checkpoint``: ``{name}.ckpt``, the
    tree {"params", "batch_stats", "opt_state", "step"} in flax's msgpack,
    with ``opt_state`` in optax's ``inject_hyperparams(adam)`` layout (the
    count, the hyperparameters, ``inner_state`` 0 = Adam's count and
    moments, 1 = the empty state), beside ``{name}.meta.json`` = {"epoch",
    "lr", "step"}; each through a temporary name and a rename. The JAX
    package resumes from it with Adam's state. Returns the ``.ckpt`` path."""
    path = _jax_ckpt_path(cfg.res_dir, cfg.experiment_name, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = jax_to_torch_names(cfg)
    variables = to_table(state.model.state_dict(), table)
    opt, tx = state.opt_state, state.tx
    moments = params_table(table)
    count = np.asarray(opt.count, np.int32)
    f32 = lambda v: np.asarray(v, np.float32)
    tree = {  # the JAX package's payload, keys sorted as its device_get leaves them
        "batch_stats": variables["batch_stats"],
        "opt_state": {
            "count": count,
            "hyperparams": {"b1": f32(tx.b1), "b2": f32(tx.b2), "eps": f32(tx.eps),
                            "eps_root": f32(0.0), "learning_rate": f32(tx.lr)},
            "hyperparams_states": {},
            "inner_state": {"0": {"count": count,
                                  "mu": to_table(opt.mu, moments)["params"],
                                  "nu": to_table(opt.nu, moments)["params"]},
                            "1": {}}},
        "params": variables["params"],
        "step": int(state.step),
    }
    for target, data in ((path, flax_format.serialize(tree)),
                         (path.removesuffix(".ckpt") + ".meta.json",
                          json.dumps({"epoch": int(epoch), "lr": float(lr),
                                      "step": int(state.step)}).encode())):
        with open(target + ".tmp", "wb") as f:
            f.write(data)
        os.replace(target + ".tmp", target)
    return path


def _check_adam(hyper: Dict, tx, path: str):
    """A JAX file's Adam hyperparameters must be this package's Adam's."""
    want = {"b1": tx.b1, "b2": tx.b2, "eps": tx.eps, "eps_root": 0.0}
    got = {k: hyper.get(k) for k in want}
    if any(got[k] is None or np.float32(got[k]) != np.float32(v) for k, v in want.items()):
        raise ValueError(f"{path}: Adam's hyperparameters {got} are not this package's "
                         f"{want}: its moments do not carry over")


def _same_keys(got, want, what: str, path: str):
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or unexpected:
        raise KeyError(f"{what} of {path} does not match the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")


@torch.no_grad()
def load_checkpoint(cfg, checkp_dir: str, state: TrainState, name: str,
                    restore_opt: bool = True) -> Tuple[TrainState, Dict]:
    """Strict restore of ``{checkp_dir}/{experiment}/{name}.pth.tar`` (or
    of ``{name}.dcp``, found first, or of the JAX package's ``{name}.ckpt``,
    found last; pending asynchronous saves are waited for) into an existing
    state: a key of the model that the file lacks, or
    one it has beyond the model, raises and names it. The step count is always
    restored; with ``restore_opt`` also Adam's moments and count and the lr
    (a JAX file's Adam hyperparameters must equal this package's).
    A file without ``optimizer_G`` (a reference checkpoint) restarts the
    optimizer from zero moments and says so. Returns (state, meta) with
    ``meta["epoch"]``."""
    path = _blob_path(checkp_dir, cfg.experiment_name, name)
    print(f"[checkpoint] reading {path}")
    blob, sd = _read(path, cfg)
    _same_keys(sd, state.model.state_dict(), "state_dict_G", path)
    state.model.load_state_dict(sd, strict=True)
    state.step = int(blob.get("step", 0))
    meta = {k: blob[k] for k in ("epoch", "lr", "step") if k in blob}
    meta["epoch"] = int(meta.get("epoch", 1))
    if not restore_opt:
        return state, meta
    opt = state.opt_state
    if "optimizer_G" in blob and "mu" in blob["optimizer_G"]:
        saved = blob["optimizer_G"]
        if "hyperparams" in saved:
            _check_adam(saved["hyperparams"], state.tx, path)
        for moments, src in ((opt.mu, saved["mu"]), (opt.nu, saved["nu"])):
            _same_keys(src, moments, "optimizer_G", path)
            for n, t in moments.items():
                t.copy_(src[n])
        opt.count = int(saved["count"])
    else:
        print(f"[checkpoint] {os.path.basename(path)} holds no optimizer state of "
              "this package: the optimizer restarts from zero moments")
        for t in (*opt.mu.values(), *opt.nu.values()):
            t.zero_()
        opt.count = 0
    if "lr" in blob:
        state = set_learning_rate(state, blob["lr"])
    return state, meta


@torch.no_grad()
def load_pretrained_partial(cfg, state: TrainState,
                            ckpt_path: str) -> Tuple[TrainState, Dict[str, float]]:
    """Transfer from a pretrained ``.pth.tar`` (or ``.dcp`` directory, or
    the JAX package's ``.ckpt``, its variables by this package's names):
    copy every tensor whose name
    and shape match (batch-norm statistics too), and freeze the copied
    parameters except the output head (names containing ``out_conv``, as
    the JAX package's paths do).
    Returns (state, freeze_mask) with the mask {parameter name: 0.0 | 1.0}
    also set on the state."""
    wait_for_checkpoints()
    _, src = _read(ckpt_path.rstrip("/"), cfg, strict=False)
    copied = set()
    for name, t in state.model.state_dict().items():
        if name in src and src[name].shape == t.shape:
            t.copy_(src[name])
            copied.add(name)
    mask = {n: 0.0 if n in copied and "out_conv" not in n else 1.0
            for n, _ in state.model.named_parameters()}
    state.freeze_mask = mask
    return state, mask


def unfreeze_all(state: TrainState) -> TrainState:
    """The --unfreeze_after epoch gate."""
    state.freeze_mask = None
    return state
