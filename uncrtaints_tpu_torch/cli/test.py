"""Inference / evaluation entry point.

Port of uncrtaints_tpu/cli/test.py: re-load the train-time conf.json
(respecting the no-overwrite list), rebuild the model, load ``model`` (best)
or ``model_epoch_{k}`` per --resume_at, run the test split, save
{split}_metrics.json.

    python -m uncrtaints_tpu_torch.cli.test --experiment_name my_run \
        --weight_folder ./results --synthetic_data --export_every 1

``--use_custom`` tests the reference's README sample instead: a 3x3 mosaic
of ``ROIs1868/73`` patches under ``--root1`` (see :func:`custom_dataset`).
"""

from __future__ import annotations

import os

import torch

from uncrtaints_tpu_torch.config import (
    NO_OVERWRITE_TEST, Config, derive, parse_config)
from uncrtaints_tpu_torch.cli.train import (
    Profile, build_datasets, data_parallel, need_outputs, save_results)
from uncrtaints_tpu_torch.data.pipeline import BatchLoader, Subset, select_collate
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint
from uncrtaints_tpu_torch.parallel import active
from uncrtaints_tpu_torch.train.engine import (
    batch_to_device, create_train_state, make_eval_step, profile_flops)
from uncrtaints_tpu_torch.train.loop import iterate
from uncrtaints_tpu_torch.train.observe import Writer, require_matplotlib


def load_test_config(argv=None) -> Config:
    cfg = parse_config(argv, mode="test")
    conf_path = (cfg.load_config or
                 os.path.join(cfg.weight_folder, cfg.experiment_name, "conf.json"))
    if os.path.isfile(conf_path):
        # the stored conf.json is already fully derived (out_conv expanded,
        # covmode resolved): no second derive(), the out_conv expansion is
        # not idempotent
        cfg = cfg.merge_json(conf_path, NO_OVERWRITE_TEST)
    else:
        cfg = derive(cfg)
    return cfg


CUSTOM_PATCHES = [171, 172, 173, 187, 188, 189, 203, 204, 205]
# the input time points and the target's, with their acquisition dates
CUSTOM_DATES = {1: "2017-07-16", 2: "2017-07-16", 3: "2017-07-16", 30: "2018-06-21"}


def custom_dataset(cfg: Config):
    """--use_custom: the mosaiced 3x3-patch sample of ROIs1868/73 at time
    points 1-3, target at 30 (the reference's test_reconstruct.py:27-36)."""
    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS, get_pairedS1
    root = os.path.expanduser(cfg.root1)
    s2 = lambda i: [f"ROIs1868/73/S2/{i}/s2_ROIs1868_73_ImgNo_{i}_{CUSTOM_DATES[i]}_patch_{j}.tif"
                    for j in CUSTOM_PATCHES]
    s2_in, s2_t = [s2(i) for i in (1, 2, 3)], s2(30)
    s1 = [get_pairedS1(pair, root, mod="s1") for pair in s2_in]
    s1_t = get_pairedS1(s2_t, root, mod="s1")
    custom = [{"input": {"S1": s1, "S2": s2_in},
               "target": {"S1": [s1_t], "S2": [s2_t]}}]
    return SEN12MSCRTS(root, split="test", region=cfg.region,
                       sample_type=cfg.sample_type, cloud_masks=cfg.cloud_masks,
                       n_input_samples=cfg.input_t, custom_samples=custom,
                       device=cfg.device)


def main(cfg: Config) -> dict:
    if cfg.plot_every > 0:
        require_matplotlib(f"plot_every={cfg.plot_every}")
    rank, world, shard, local_bs = data_parallel(cfg)
    lead = rank == 0  # the metrics file and the observer come from rank 0 alone
    trace = Profile(cfg.trace_dir, rank)
    exp_dir = os.path.join(cfg.res_dir, cfg.experiment_name)
    if lead:
        os.makedirs(exp_dir, exist_ok=True)
    writer = Writer(os.path.join(os.path.dirname(cfg.res_dir) or ".",
                                 "logs", cfg.experiment_name + "_test")) if lead else None

    if cfg.use_custom:
        dt_test = custom_dataset(cfg)
    else:
        _, _, dt_test = build_datasets(cfg)
        dt_test = Subset(dt_test, range(0, min(cfg.max_samples_count,
                                               len(dt_test))))
    test_loader = BatchLoader(dt_test, batch_size=local_bs,
                              shuffle=False, collate=select_collate(cfg),
                              use_sar=cfg.use_sar,
                              num_workers=max(1, cfg.num_workers),
                              drop_last=False, shard=shard)

    state = create_train_state(cfg, get_generator(cfg))
    ckpt_name = "model" if cfg.resume_at < 0 else f"model_epoch_{cfg.resume_at}"
    state, meta = load_checkpoint(cfg, cfg.weight_folder, state, ckpt_name,
                                  restore_opt=False)
    epoch = meta.get("epoch", 1)
    if cfg.profile and lead:
        profile_flops(cfg, state.model, batch_to_device(next(iter(test_loader)), cfg.device))

    eval_step = make_eval_step(cfg, with_metrics=True,
                               return_outputs=need_outputs(cfg))
    state, metrics, img_metrics_val = iterate(
        state, test_loader, cfg, writer, "test", epoch, eval_step=eval_step)
    trace.stop()
    print(f"Test loss {metrics['test_loss']}")
    print(f"Test image metrics: {img_metrics_val}")
    if lead:
        save_results(img_metrics_val, exp_dir, split="test")
        writer.close()
    return img_metrics_val


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-test); one process a
    GPU under ``torchrun --nproc_per_node N ... --mesh_shape N``."""
    try:
        main(load_test_config())
    finally:
        if active():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    cli_main()
