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
conversion. The JAX package's own ``.ckpt`` (flax msgpack) and ``.orbax``
checkpoints are not read here: that needs flax. ``cfg.ckpt_backend`` keeps
its default "msgpack", which in this package means this single-file
format; "orbax" raises (``config.reject_unported``).

A reference file's running variance of ``LTAE2d``'s ``BatchNorm1d``
(``temporal_encoder.mlp.1.running_var``) is PyTorch's unbiased estimate,
while this package keeps the biased one (as flax does). The value is loaded
as it stands, never rescaled: over the n = B*H*W rows of a training batch
the two differ by the factor n / (n - 1).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import torch

from uncrtaints_tpu_torch.train.engine import TrainState, set_learning_rate


def _ckpt_path(res_dir: str, experiment: str, name: str) -> str:
    return os.path.join(res_dir, experiment, f"{name}.pth.tar")


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


def _read(path: str) -> Tuple[Dict, Dict]:
    """(the file's blob, its normalized model state dict)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict_G", blob)
    return blob, normalize_legacy_keys(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


def save_checkpoint(cfg, epoch: int, state: TrainState, name: str,
                    lr: float) -> str:
    """Write the {name} checkpoint (to a temporary name, then renamed, so a
    reader never finds half a file). Returns its path."""
    path = _ckpt_path(cfg.res_dir, cfg.experiment_name, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    opt = state.opt_state
    blob = {
        "epoch": int(epoch),
        "state_dict_G": cpu(state.model.state_dict()),
        "optimizer_G": {"count": int(opt.count), "mu": cpu(opt.mu), "nu": cpu(opt.nu)},
        "lr": float(lr),
        "step": int(state.step),
    }
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def _same_keys(got, want, what: str, path: str):
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or unexpected:
        raise KeyError(f"{what} of {path} does not match the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")


@torch.no_grad()
def load_checkpoint(cfg, checkp_dir: str, state: TrainState, name: str,
                    restore_opt: bool = True) -> Tuple[TrainState, Dict]:
    """Strict restore of ``{checkp_dir}/{experiment}/{name}.pth.tar`` into
    an existing state: a key of the model that the file lacks, or one it
    has beyond the model, raises and names it. The step count is always
    restored; with ``restore_opt`` also Adam's moments and count and the lr.
    A file without ``optimizer_G`` (a reference checkpoint) restarts the
    optimizer from zero moments and says so. Returns (state, meta) with
    ``meta["epoch"]``."""
    path = _ckpt_path(checkp_dir, cfg.experiment_name, name)
    blob, sd = _read(path)
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
    """Transfer from a pretrained ``.pth.tar``: copy every tensor whose name
    and shape match (batch-norm statistics too), and freeze the copied
    parameters except the output head (names containing ``out_conv``).
    Returns (state, freeze_mask) with the mask {parameter name: 0.0 | 1.0}
    also set on the state."""
    _, src = _read(ckpt_path)
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
