"""One rank of the port's data-parallel runs on the CPU (gloo), started by
``tests/test_torch_parallel.py`` with torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT):

    python tests/_torch_parallel_worker.py <out_dir> <job> [<job> ...]

Jobs run in the order given. ``steps``: two train steps of the tiny recipe on two global batches of 5
samples (this rank's rows of each) and an eval epoch of 5 samples through
the loop; writes ``steps_rank<r>.pt``. ``cli``: ``cli.train`` for one epoch
with its file writers counted; writes ``cli_rank<r>.pt``."""

import os
import sys

import numpy as np
import torch

from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.data import BatchLoader, SyntheticSEN12MSCRTS, collate_multi
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.parallel import current_mesh, maybe_init_distributed, shard_batch
from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state, make_eval_step,
                                        make_train_step)
from uncrtaints_tpu_torch.train.loop import iterate

PATCH, GLOBAL_B = 16, 5


def tiny_cfg(**kw):
    """fp32, batch-norm decoder, 16x16 patches (no upsampled attention, so
    no dropout draws)."""
    base = dict(use_sar=True, scale_by=10.0, lr=1e-3, input_t=3, device="cpu",
                compute_dtype="float32", encoder_widths=[16], decoder_widths=[16, 16],
                n_head=4, d_model=32, batch_size=GLOBAL_B)
    base.update(kw)
    return derive(Config(**base))


def global_batches():
    """The two global batches of the train steps, as numpy."""
    ds = SyntheticSEN12MSCRTS(n_samples=2 * GLOBAL_B, n_input_t=3, patch_size=PATCH, seed=4)
    return [collate_multi([ds[i] for i in range(j * GLOBAL_B, (j + 1) * GLOBAL_B)])
            for j in range(2)]


def eval_dataset():
    return SyntheticSEN12MSCRTS(n_samples=GLOBAL_B, n_input_t=3, patch_size=PATCH, seed=5)


def train_two_steps(cfg, batches):
    """(the two steps' losses, the model's state_dict after each step, the
    first step's gradients) of two train steps on ``batches`` (numpy, this
    process's rows)."""
    model = get_generator(cfg)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    losses, states, grads = [], [], []
    for b in batches:
        state, aux = step(state, batch_to_device(b, "cpu"), gen)
        losses.append(float(aux["loss"]))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
        grads.append(aux["grads"])
    return losses, states, grads[0]


def eval_epoch(cfg, batch_size, shard=None):
    """(val loss, image metrics) of an eval epoch of the freshly seeded
    model (not the trained one: its noise-level parameters, moved by Adam,
    differ between one process and the ranks; see the test's tolerances)."""
    loader = BatchLoader(eval_dataset(), batch_size=batch_size, collate=collate_multi,
                         num_workers=1, drop_last=False, shard=shard)
    state = create_train_state(cfg, get_generator(cfg))
    _, metrics, img = iterate(state, loader, cfg, None, "val", 1,
                              eval_step=make_eval_step(cfg, with_metrics=True))
    return metrics["val_loss"], img


def job_steps(out_dir, rank, world):
    cfg = tiny_cfg()
    mesh = current_mesh()
    losses, states, _ = train_two_steps(cfg, [shard_batch(b, mesh) for b in global_batches()])
    val_loss, img = eval_epoch(cfg, 2, shard=(rank, world))
    torch.save({"losses": losses, "states": states, "val_loss": val_loss, "img": img},
               os.path.join(out_dir, f"steps_rank{rank}.pt"))


def job_cli(out_dir, rank, world):
    # the observer's own fallback for a machine without tensorboard (JSONL):
    # its import pulls in tensorflow here, seconds that the check does not need
    sys.modules["torch.utils.tensorboard"] = None
    from uncrtaints_tpu_torch.cli import train as cli_train
    from uncrtaints_tpu_torch.train import loop
    calls = {"checkpoints": [], "conf": 0, "exports": []}
    save = cli_train.save_checkpoint
    cli_train.save_checkpoint = lambda cfg, epoch, state, name, lr: (
        calls["checkpoints"].append(name), save(cfg, epoch, state, name, lr))[1]
    save_json = Config.save_json
    Config.save_json = lambda self, path: (calls.__setitem__("conf", calls["conf"] + 1),
                                           save_json(self, path))[1]
    export = loop.export
    loop.export = lambda arr, mod, d, file_id=None: (
        calls["exports"].append((os.path.basename(d), mod, file_id)), export(arr, mod, d, file_id))[1]
    cfg = tiny_cfg(batch_size=4, epochs=1, max_samples_count=GLOBAL_B, synthetic_data=True,
                   synthetic_patch=PATCH, res_dir=os.path.join(out_dir, "results"),
                   experiment_name="dp", plot_every=-1, export_every=1, mesh_shape=world)
    out = cli_train.main(cfg)
    torch.save({"calls": calls, "test": out["test"]}, os.path.join(out_dir, f"cli_rank{rank}.pt"))


if __name__ == "__main__":
    out_dir, jobs = sys.argv[1], sys.argv[2:]
    rank, world = maybe_init_distributed("cpu")
    np.random.seed(0)
    try:
        for job in jobs:
            {"steps": job_steps, "cli": job_cli}[job](out_dir, rank, world)
    finally:
        torch.distributed.destroy_process_group()
