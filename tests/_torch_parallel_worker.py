"""One rank of the port's data-parallel runs on the CPU (gloo), started by
``tests/test_torch_parallel.py`` with torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT):

    python tests/_torch_parallel_worker.py <out_dir> <job> [<job> ...]

Jobs run in the order given. ``steps``: two train steps of the tiny recipe on two global batches of 5
samples (this rank's rows of each) and an eval epoch of 5 samples through
the loop; writes ``steps_rank<r>.pt``. ``cli``: ``cli.train`` for one epoch
with its file writers counted; writes ``cli_rank<r>.pt``. ``spatial``: on a
2 x (world / 2) data x spatial mesh, with the weights, batch and scene of
``spatial_inputs.pt`` (written by ``tests/test_torch_spatial.py``): the halo
exchange's gradient through K5's halo mode, the eval step (also with the
attention pooled and upsampled), one train step, a ``.dcp`` checkpoint
written by rank 0 and read by every rank, and ``predict_scene``; writes
``spatial_rank<r>.pt``."""

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


def dcp_round_trip(cfg, state, rank):
    """Rank 0 writes a ``.dcp`` checkpoint asynchronously inside the process
    group, every rank reads it back: whether each rank's copy equals its
    state."""
    from uncrtaints_tpu_torch.parallel import barrier
    from uncrtaints_tpu_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                                       wait_for_checkpoints)
    if rank == 0:
        save_checkpoint(cfg, 1, state, "model", cfg.lr)
        wait_for_checkpoints()
    barrier()
    fresh, _ = load_checkpoint(cfg, cfg.res_dir, create_train_state(cfg, get_generator(cfg)),
                               "model")
    a, b = state.model.state_dict(), fresh.model.state_dict()
    return all(torch.equal(a[k], b[k]) for k in a) and fresh.opt_state.count == 1


def job_spatial(out_dir, rank, world):
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.ops.dwconv import dw_stencil
    from uncrtaints_tpu_torch.parallel import halo_exchange, make_mesh_2d
    inp = torch.load(os.path.join(out_dir, "spatial_inputs.pt"), weights_only=False)
    mesh = make_mesh_2d(2, world // 2)
    s, ns = mesh.spatial_rank, mesh.n_spatial
    res = {"coords": (mesh.data_rank, s)}

    # the halo exchange's backward: this band's share of the whole conv's
    # gradients (the test stitches and sums them)
    x, w, gy = inp["halo"]
    band = x.shape[1] // ns
    rows = slice(s * band, (s + 1) * band)
    xb = x[:, rows].clone().requires_grad_()
    wb = w.clone().requires_grad_()
    y = dw_stencil(xb, wb, ((1, 1), (1, 1)), "reflect", halo=halo_exchange(xb, 1))
    (y * gy[:, rows]).sum().backward()
    res["halo"] = (y.detach(), xb.grad, wb.grad)

    batch = shard_batch(inp["batch"], mesh)
    for name, kw in inp["configs"].items():
        cfg = derive(Config(**kw))
        model = get_generator(cfg)
        model.load_state_dict(inp["state_dict"])
        res[f"eval {name}"] = make_eval_step(cfg, with_metrics=True)(
            model, batch_to_device(batch, "cpu"))
        if name != "tiny":
            continue
        state, aux = make_train_step(cfg)(create_train_state(cfg, model),
                                          batch_to_device(batch, "cpu"),
                                          torch.Generator().manual_seed(0))
        res["train"] = {"loss": float(aux["loss"]), "grads": aux["grads"],
                        "state": {k: v.clone() for k, v in model.state_dict().items()}}
        res["dcp"] = dcp_round_trip(cfg.replace(ckpt_backend="orbax", res_dir=out_dir,
                                                experiment_name="dcp"), state, rank)
        model.load_state_dict(inp["state_dict"])
        scene, dates = inp["scene"]
        res["scene"] = predict_scene(model, cfg, scene, dates, mesh=mesh, **inp["scene_kw"])
    torch.save(res, os.path.join(out_dir, f"spatial_rank{rank}.pt"))


if __name__ == "__main__":
    out_dir, jobs = sys.argv[1], sys.argv[2:]
    rank, world = maybe_init_distributed("cpu")
    np.random.seed(0)
    try:
        for job in jobs:
            {"steps": job_steps, "cli": job_cli, "spatial": job_spatial}[job](
                out_dir, rank, world)
    finally:
        torch.distributed.destroy_process_group()
