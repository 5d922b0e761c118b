"""Training entry point.

Port of uncrtaints_tpu/cli/train.py: the reference's flags, derived rules,
epoch/val/test schedule, checkpointing, trainlog.json and conf.json, on the
port's steps and one device. Usage:

    python -m uncrtaints_tpu_torch.cli.train --experiment_name my_run \
        --synthetic_data --max_samples_count 8 --epochs 1 --lr 1e-3 \
        --batch_size 4 --scale_by 10 --loss MGNLL --covmode diag --use_sar

The run is on ``--device`` ("cuda" by default; without a card it raises, it
never moves to the CPU; pass ``--device cpu`` for a CPU run). Only the
synthetic data source is ported so far (``--synthetic_data``).
"""

from __future__ import annotations

import json
import os
import pprint
import random
from typing import Optional

import numpy as np
import torch

from uncrtaints_tpu_torch.config import (
    Config, apply_resume, derive, parse_config, reject_unported)
from uncrtaints_tpu_torch.data.pipeline import BatchLoader, Subset, select_collate
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train.checkpoint import (
    load_checkpoint, load_pretrained_partial, save_checkpoint, unfreeze_all)
from uncrtaints_tpu_torch.train.engine import (
    create_train_state, epoch_lr, make_eval_step, make_train_step, set_learning_rate)
from uncrtaints_tpu_torch.train.loop import iterate
from uncrtaints_tpu_torch.train.observe import Writer, require_matplotlib


def seed_everything(seed: int):
    """Fix the host-side seeds (python, numpy, torch)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def import_from_path(split: str, cfg: Config) -> Optional[str]:
    """Locate precomputed cloud statistics."""
    p = os.path.join(
        cfg.precomputed,
        f"generic_{cfg.input_t}_{split}_{cfg.region}_{cfg.cloud_masks}.npy")
    return p if os.path.isfile(p) else None


def build_datasets(cfg: Config):
    if cfg.synthetic_data:
        from uncrtaints_tpu_torch.data.synthetic import (
            SyntheticSEN12MSCR, SyntheticSEN12MSCRTS)
        n = min(cfg.max_samples_count, 64)
        ps = cfg.synthetic_patch
        if cfg.pretrain:
            mk = lambda seed: SyntheticSEN12MSCR(n_samples=n, patch_size=ps,
                                                 seed=seed)
        else:
            mk = lambda seed: SyntheticSEN12MSCRTS(
                n_samples=n, n_input_t=cfg.input_t, patch_size=ps, seed=seed)
        return mk(1), mk(2), mk(3)
    raise NotImplementedError(
        "the SEN12MS-CR and SEN12MS-CR-TS datasets are not ported yet (ROADMAP.md "
        "section 1, the datasets item): run with --synthetic_data")


def need_outputs(cfg: Config) -> bool:
    """Predictions leave the eval step only for plot/export items and the
    aleatoric panels; with all three off the metrics-only step drops the
    full-resolution fp32 outputs."""
    return (cfg.plot_every > 0 or cfg.export_every > 0
            or cfg.loss in ("GNLL", "MGNLL"))


def checkpoint_name(path: str) -> str:
    """``.../model_epoch_k.pth.tar`` -> ``model_epoch_k``."""
    name = os.path.basename(path.rstrip("/"))
    if not name.endswith(".pth.tar"):
        raise ValueError(f"{path}: this package reads .pth.tar checkpoints only "
                         "(not the JAX package's .ckpt or .orbax)")
    return name.removesuffix(".pth.tar")


def main(cfg: Config) -> dict:
    reject_unported(cfg)
    if cfg.plot_every > 0:
        require_matplotlib(f"plot_every={cfg.plot_every}")
    exp_dir = os.path.join(cfg.res_dir, cfg.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    seed_everything(cfg.rdm_seed)
    pprint.pprint(cfg.to_dict())

    writer = Writer(os.path.join(os.path.dirname(cfg.res_dir) or ".",
                                 "logs", cfg.experiment_name))

    dt_train, dt_val, dt_test = build_datasets(cfg)
    cap = lambda ds: Subset(ds, range(0, min(
        cfg.max_samples_count, len(ds), int(len(ds) * cfg.max_samples_frac))))
    dt_train, dt_val, dt_test = cap(dt_train), cap(dt_val), cap(dt_test)
    print(f"Train {len(dt_train)}, Val {len(dt_val)}, Test {len(dt_test)}")

    collate = select_collate(cfg)
    # drop_last=False for all splits, as the reference's DataLoader default:
    # the tail batch trains and is evaluated too
    mk_loader = lambda ds, shuffle, seed: BatchLoader(
        ds, batch_size=cfg.batch_size, shuffle=shuffle, seed=seed,
        collate=collate, use_sar=cfg.use_sar, drop_last=False,
        num_workers=max(1, cfg.num_workers))
    train_loader = mk_loader(dt_train, True, cfg.rdm_seed)
    val_loader = mk_loader(dt_val, False, cfg.rdm_seed)
    test_loader = mk_loader(dt_test, False, cfg.rdm_seed)

    model = get_generator(cfg)
    state = create_train_state(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = cfg.replace(N_params=n_params)
    print(f"TOTAL TRAINABLE PARAMETERS: {n_params}")

    frozen = False
    if cfg.trained_checkp:
        print(f"Loading weights from (pre-)trained checkpoint {cfg.trained_checkp}")
        state, _ = load_pretrained_partial(cfg, state, cfg.trained_checkp)
        frozen = True

    cfg.save_json(os.path.join(exp_dir, "conf.json"))

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg, with_metrics=True,
                               return_outputs=need_outputs(cfg))
    generator = torch.Generator(device=next(model.parameters()).device)

    trainlog, best_loss = {}, float("inf")
    begin_at = cfg.resume_at if cfg.resume_at >= 0 else 0
    if cfg.resume_from and cfg.trained_checkp:
        state, meta = load_checkpoint(cfg, cfg.res_dir, state,
                                      checkpoint_name(cfg.trained_checkp))
        begin_at = meta.get("epoch", begin_at)

    for epoch in range(begin_at + 1, cfg.epochs + 1):
        print(f"\nEPOCH {epoch}/{cfg.epochs}")
        # unfreeze all layers after the gate epoch
        if epoch > cfg.unfreeze_after and frozen:
            print("Unfreezing all network layers")
            state, frozen = unfreeze_all(state), False

        lr = epoch_lr(cfg, epoch - 1)  # constant within the epoch
        state = set_learning_rate(state, lr)
        writer.add_scalar("Etc/train/lr", lr, epoch)

        if cfg.vary_samples:
            train_loader.set_epoch(epoch)  # epoch-seeded reshuffle
            # epoch_count drives a dataset's 'random' sampler rng; set (not
            # increment) so resumed runs land on the same per-epoch state
            base = dt_train.dataset if hasattr(dt_train, "dataset") else dt_train
            if hasattr(base, "set_epoch_count"):
                base.set_epoch_count(epoch - 1)
            elif hasattr(base, "incr_epoch_count") and epoch > 1:
                base.incr_epoch_count()

        state, train_metrics, _ = iterate(
            state, train_loader, cfg, writer, "train", epoch,
            train_step=train_step, generator=generator)

        if epoch % cfg.val_every == 0 and epoch > cfg.val_after:
            print("Validation . . . ")
            state, val_metrics, val_img_metrics = iterate(
                state, val_loader, cfg, writer, "val", epoch, eval_step=eval_step)
            val_loss = val_metrics["val_loss"]
            print(f"Validation Loss {val_loss}")
            print(f"validation image metrics: {val_img_metrics}")
            save_results(val_img_metrics, exp_dir, split=f"val_epoch_{epoch}")
            trainlog[epoch] = {**train_metrics, **val_metrics}
            checkpoint_log(trainlog, cfg)
            if val_loss <= best_loss:
                best_loss = val_loss
                save_checkpoint(cfg, epoch, state, "model", lr)
        else:
            trainlog[epoch] = {**train_metrics}
            checkpoint_log(trainlog, cfg)

        save_checkpoint(cfg, epoch, state, f"model_epoch_{epoch}", lr)
        print(f"Completed current epoch of experiment {cfg.experiment_name}.")

    # test the best checkpoint (fall back to the last epoch if validation
    # never ran and no best-on-val checkpoint exists)
    print("Testing best epoch . . .")
    best_name = "model" if os.path.exists(os.path.join(exp_dir, "model.pth.tar")) \
        else f"model_epoch_{cfg.epochs}"
    state, _ = load_checkpoint(cfg, cfg.res_dir, state, best_name)
    state, test_metrics, test_img_metrics = iterate(
        state, test_loader, cfg, writer, "test", cfg.epochs, eval_step=eval_step)
    print(f"Test Loss {test_metrics['test_loss']}")
    print(f"Test image metrics: {test_img_metrics}")
    save_results(test_img_metrics, exp_dir, split="test")
    writer.close()
    print(f"Finished training experiment {cfg.experiment_name}.")
    return {"trainlog": trainlog, "test": test_img_metrics}


def checkpoint_log(log: dict, cfg: Config):
    with open(os.path.join(cfg.res_dir, cfg.experiment_name,
                           "trainlog.json"), "w") as f:
        json.dump(log, f, indent=4)


def save_results(metrics: dict, path: str, split: str = "test"):
    clean = {k: (float(v) if np.ndim(v) == 0 else None)
             for k, v in metrics.items()}
    with open(os.path.join(path, f"{split}_metrics.json"), "w") as f:
        json.dump({k: v for k, v in clean.items() if v is not None}, f, indent=4)


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-train)."""
    cfg = derive(parse_config(mode="train"))
    cfg = apply_resume(cfg)
    main(cfg)


if __name__ == "__main__":
    cli_main()
