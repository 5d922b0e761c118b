"""Inference / evaluation entry point.

Port of uncrtaints_tpu/cli/test.py: re-load the train-time conf.json
(respecting the no-overwrite list), rebuild the model, load ``model`` (best)
or ``model_epoch_{k}`` per --resume_at, run the test split, save
{split}_metrics.json.

    python -m uncrtaints_tpu_torch.cli.test --experiment_name my_run \
        --weight_folder ./results --synthetic_data --export_every 1

``--use_custom`` (user-specified mosaiced patches) needs the real dataset
and raises until that is ported.
"""

from __future__ import annotations

import os

from uncrtaints_tpu_torch.config import (
    NO_OVERWRITE_TEST, Config, derive, parse_config, reject_unported)
from uncrtaints_tpu_torch.cli.train import build_datasets, need_outputs, save_results
from uncrtaints_tpu_torch.data.pipeline import BatchLoader, Subset, select_collate
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint
from uncrtaints_tpu_torch.train.engine import create_train_state, make_eval_step
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


def custom_dataset(cfg: Config):
    """--use_custom: a mosaiced 3x3-patch sample of the real dataset."""
    raise NotImplementedError(
        "--use_custom needs the SEN12MS-CR-TS dataset, which is not ported yet "
        "(ROADMAP.md section 1, the datasets item)")


def main(cfg: Config) -> dict:
    reject_unported(cfg)
    if cfg.plot_every > 0:
        require_matplotlib(f"plot_every={cfg.plot_every}")
    exp_dir = os.path.join(cfg.res_dir, cfg.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    writer = Writer(os.path.join(os.path.dirname(cfg.res_dir) or ".",
                                 "logs", cfg.experiment_name + "_test"))

    if cfg.use_custom:
        dt_test = custom_dataset(cfg)
    else:
        _, _, dt_test = build_datasets(cfg)
        dt_test = Subset(dt_test, range(0, min(cfg.max_samples_count,
                                               len(dt_test))))
    test_loader = BatchLoader(dt_test, batch_size=cfg.batch_size,
                              shuffle=False, collate=select_collate(cfg),
                              use_sar=cfg.use_sar,
                              num_workers=max(1, cfg.num_workers),
                              drop_last=False)

    state = create_train_state(cfg, get_generator(cfg))
    ckpt_name = "model" if cfg.resume_at < 0 else f"model_epoch_{cfg.resume_at}"
    state, meta = load_checkpoint(cfg, cfg.weight_folder, state, ckpt_name,
                                  restore_opt=False)
    epoch = meta.get("epoch", 1)

    eval_step = make_eval_step(cfg, with_metrics=True,
                               return_outputs=need_outputs(cfg))
    state, metrics, img_metrics_val = iterate(
        state, test_loader, cfg, writer, "test", epoch, eval_step=eval_step)
    print(f"Test loss {metrics['test_loss']}")
    print(f"Test image metrics: {img_metrics_val}")
    save_results(img_metrics_val, exp_dir, split="test")
    writer.close()
    return img_metrics_val


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-test)."""
    main(load_test_config())


if __name__ == "__main__":
    cli_main()
