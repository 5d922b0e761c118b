"""Training entry point.

Port of uncrtaints_tpu/cli/train.py: the reference's flags, derived rules,
epoch/val/test schedule, checkpointing, trainlog.json and conf.json, on the
port's steps and one device. Usage:

    python -m uncrtaints_tpu_torch.cli.train --experiment_name my_run \
        --synthetic_data --max_samples_count 8 --epochs 1 --lr 1e-3 \
        --batch_size 4 --scale_by 10 --loss MGNLL --covmode diag --use_sar

or, on a SEN12MS-CR-TS tree (coverage statistics from cli/precompute.py):

    python -m uncrtaints_tpu_torch.cli.train --experiment_name my_run \
        --root1 ~/data/SEN12MSCRTS --root2 ~/data/SEN12MSCRTS \
        --precomputed ./precomputed --cloud_masks cloud_cloudshadow_mask \
        --use_sar --scale_by 10 --loss MGNLL --covmode diag

The run, and the cloud masks of the datasets, are on ``--device`` ("cuda"
by default; without a card it raises, it never moves to the CPU; pass
``--device cpu`` for a CPU run). On N GPUs, one process a card:

    torchrun --nproc_per_node N -m uncrtaints_tpu_torch.cli.train \
        --mesh_shape N ...

Each rank loads its rows of every global batch of ``--batch_size``; the
gradients and the batch-norm statistics are the global batch's
(parallel/mesh.py); checkpoints, conf.json, the logs and the metrics files
come from rank 0.
"""

from __future__ import annotations

import json
import os
import pprint
import random
from typing import Optional

import numpy as np
import torch

from uncrtaints_tpu_torch.config import Config, apply_resume, derive, parse_config
from uncrtaints_tpu_torch.data.pipeline import BatchLoader, Subset, select_collate
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train.checkpoint import (
    load_checkpoint, load_pretrained_partial, save_checkpoint, unfreeze_all,
    wait_for_checkpoints)
from uncrtaints_tpu_torch.parallel import (
    active, barrier, broadcast_module, make_mesh, maybe_init_distributed)
from uncrtaints_tpu_torch.train.engine import (
    batch_to_device, create_train_state, epoch_lr, make_eval_step, make_train_step,
    profile_flops, set_learning_rate)
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

    if cfg.pretrain:
        from uncrtaints_tpu_torch.data.sen12mscr import SEN12MSCR
        root = os.path.expanduser(cfg.root3)
        mk = lambda split: SEN12MSCR(root, split=split, region=cfg.region,
                                     sample_type=cfg.sample_type,
                                     cloud_masks=cfg.cloud_masks, device=cfg.device)
        return mk("train"), mk("val"), mk("test")

    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS
    dt_train = SEN12MSCRTS(
        os.path.expanduser(cfg.root1), split="train", region=cfg.region,
        sample_type=cfg.sample_type, cloud_masks=cfg.cloud_masks,
        sampler="random" if cfg.vary_samples else "fixed",
        n_input_samples=cfg.input_t,
        import_data_path=import_from_path("train", cfg),
        min_cov=cfg.min_cov, max_cov=cfg.max_cov, seed=cfg.rdm_seed, device=cfg.device)
    dt_val, dt_test = (SEN12MSCRTS(
        os.path.expanduser(cfg.root2), split=split, region="all",
        sample_type=cfg.sample_type, cloud_masks=cfg.cloud_masks,
        n_input_samples=cfg.input_t,
        import_data_path=import_from_path(split, cfg), device=cfg.device)
        for split in ("val", "test"))
    return dt_train, dt_val, dt_test


def need_outputs(cfg: Config) -> bool:
    """Predictions leave the eval step only for plot/export items and the
    aleatoric panels; with all three off the metrics-only step drops the
    full-resolution fp32 outputs."""
    return (cfg.plot_every > 0 or cfg.export_every > 0
            or cfg.loss in ("GNLL", "MGNLL"))


CHECKPOINT_SUFFIXES = (".pth.tar", ".dcp")  # --ckpt_backend msgpack, orbax


def checkpoint_name(path: str) -> str:
    """``.../model_epoch_k.pth.tar`` (or ``.dcp``) -> ``model_epoch_k``."""
    name = os.path.basename(path.rstrip("/"))
    for suffix in CHECKPOINT_SUFFIXES:
        if name.endswith(suffix):
            return name.removesuffix(suffix)
    raise ValueError(f"{path}: this package reads .pth.tar checkpoints and .dcp directories "
                     "only (not the JAX package's .ckpt or .orbax)")


def data_parallel(cfg: Config):
    """Join the process group the environment names (parallel/mesh.py) and
    check ``--mesh_shape`` against it: (rank, world, the loaders' shard or
    None, the per-rank batch size). The global batch is ``cfg.batch_size``;
    each rank loads its 1/world of it."""
    rank, world = maybe_init_distributed(cfg.device)
    if cfg.mesh_shape is not None and cfg.mesh_shape != world:
        make_mesh(cfg.mesh_shape)  # raises on a shortfall
        raise RuntimeError(f"mesh_shape={cfg.mesh_shape} but the run has {world} ranks "
                           f"(torchrun --nproc_per_node {cfg.mesh_shape})")
    if not active():
        return rank, world, None, cfg.batch_size
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the "
                         f"{world} data-parallel ranks")
    print(f"Data parallel: rank {rank} of {world}, {cfg.batch_size // world} samples "
          "a rank and step")
    return rank, world, (rank, world), cfg.batch_size // world


class Profile:
    """``--trace_dir``: a ``torch.profiler`` trace (CPU and CUDA activities)
    from the start of the run to the end of its first epoch (the JAX CLI
    traces the whole run; one epoch bounds the file), written as a Chrome
    trace JSON ``trace_rank<r>.json`` under the directory."""

    def __init__(self, trace_dir: str, rank: int):
        self.path = os.path.join(trace_dir, f"trace_rank{rank}.json") if trace_dir else ""
        self.prof = None
        if self.path:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def stop(self):
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print(f"Wrote profiler trace to {self.path}")


def main(cfg: Config) -> dict:
    if cfg.plot_every > 0:
        require_matplotlib(f"plot_every={cfg.plot_every}")
    rank, world, shard, local_bs = data_parallel(cfg)
    lead = rank == 0  # files, logs and the observer come from rank 0 alone
    trace = Profile(cfg.trace_dir, rank)
    exp_dir = os.path.join(cfg.res_dir, cfg.experiment_name)
    if lead:
        os.makedirs(exp_dir, exist_ok=True)
    seed_everything(cfg.rdm_seed)
    if lead:
        pprint.pprint(cfg.to_dict())

    writer = Writer(os.path.join(os.path.dirname(cfg.res_dir) or ".",
                                 "logs", cfg.experiment_name)) if lead else None

    dt_train, dt_val, dt_test = build_datasets(cfg)
    cap = lambda ds: Subset(ds, range(0, min(
        cfg.max_samples_count, len(ds), int(len(ds) * cfg.max_samples_frac))))
    dt_train, dt_val, dt_test = cap(dt_train), cap(dt_val), cap(dt_test)
    print(f"Train {len(dt_train)}, Val {len(dt_val)}, Test {len(dt_test)}")

    collate = select_collate(cfg)
    # drop_last=False for all splits, as the reference's DataLoader default:
    # the tail batch trains and is evaluated too
    mk_loader = lambda ds, shuffle, seed: BatchLoader(
        ds, batch_size=local_bs, shuffle=shuffle, seed=seed,
        collate=collate, use_sar=cfg.use_sar, drop_last=False,
        num_workers=max(1, cfg.num_workers), shard=shard)
    train_loader = mk_loader(dt_train, True, cfg.rdm_seed)
    val_loader = mk_loader(dt_val, False, cfg.rdm_seed)
    test_loader = mk_loader(dt_test, False, cfg.rdm_seed)

    model = get_generator(cfg)
    if shard is not None:  # every rank starts from rank 0's weights
        broadcast_module(model)
    state = create_train_state(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = cfg.replace(N_params=n_params)
    print(f"TOTAL TRAINABLE PARAMETERS: {n_params}")
    if cfg.profile and lead:
        profile_flops(cfg, model, batch_to_device(
            next(iter(mk_loader(dt_train, False, cfg.rdm_seed))), cfg.device))

    frozen = False
    if cfg.trained_checkp:
        print(f"Loading weights from (pre-)trained checkpoint {cfg.trained_checkp}")
        state, _ = load_pretrained_partial(cfg, state, cfg.trained_checkp)
        frozen = True

    if lead:
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
        if writer is not None:
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
            trainlog[epoch] = {**train_metrics, **val_metrics}
            if lead:
                save_results(val_img_metrics, exp_dir, split=f"val_epoch_{epoch}")
                checkpoint_log(trainlog, cfg)
            if val_loss <= best_loss:
                best_loss = val_loss
                if lead:
                    save_checkpoint(cfg, epoch, state, "model", lr)
        else:
            trainlog[epoch] = {**train_metrics}
            if lead:
                checkpoint_log(trainlog, cfg)

        if lead:
            save_checkpoint(cfg, epoch, state, f"model_epoch_{epoch}", lr)
        print(f"Completed current epoch of experiment {cfg.experiment_name}.")
        trace.stop()  # the trace holds the first epoch
    trace.stop()
    # an asynchronous (.dcp) save lands under its name only when written
    wait_for_checkpoints()
    barrier()  # the checkpoints rank 0 wrote are read by every rank below

    # test the best checkpoint (fall back to the last epoch if validation
    # never ran and no best-on-val checkpoint exists)
    print("Testing best epoch . . .")
    best = any(os.path.exists(os.path.join(exp_dir, "model" + x)) for x in CHECKPOINT_SUFFIXES)
    best_name = "model" if best else f"model_epoch_{cfg.epochs}"
    state, _ = load_checkpoint(cfg, cfg.res_dir, state, best_name)
    state, test_metrics, test_img_metrics = iterate(
        state, test_loader, cfg, writer, "test", cfg.epochs, eval_step=eval_step)
    print(f"Test Loss {test_metrics['test_loss']}")
    print(f"Test image metrics: {test_img_metrics}")
    if lead:
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
    """Console entry point (pyproject: uncrtaints-torch-train); one process
    a GPU under ``torchrun --nproc_per_node N ... --mesh_shape N``."""
    cfg = derive(parse_config(mode="train"))
    cfg = apply_resume(cfg)
    try:
        main(cfg)
    finally:
        wait_for_checkpoints()  # asynchronous saves must land before the exit
        if active():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    cli_main()
