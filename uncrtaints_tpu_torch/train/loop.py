"""The shared train/val/test epoch loop.

Port of uncrtaints_tpu/train/loop.py:iterate on the port's steps: one step
per batch, per-item image metrics at eval, TensorBoard panels, plot/export
hooks, and epoch-end calibration (ECE discard curve, UCE/AUCE).

The loop makes the host wait for the device only where the host needs a
value: at the display cadence of the train log, where a plot or export
sample is due, and once at the epoch's end, when the losses and the
{name: [B]} metric vectors of every step are stacked on the device and
copied in one transfer. On a CUDA device a batch goes to pinned memory and
is copied on a side stream while the step before it still runs.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from uncrtaints_tpu_torch import tracing
from uncrtaints_tpu_torch.config import Config
from uncrtaints_tpu_torch.metrics import (
    AvgImgMetrics, compute_ece, compute_uce_auce, img_metrics_batch)
from uncrtaints_tpu_torch.parallel.mesh import (
    Mesh, active, current_mesh, row_split, shard_batch)
from uncrtaints_tpu_torch.train.engine import batch_to_device
from uncrtaints_tpu_torch.train.observe import (
    Writer, diag_to_covar, export, plot_discard, plot_err_vs_var, plot_img, plot_mask,
    pyplot)


def _patch_covmat_figures(writer: Writer, mode: str, step: int, var: np.ndarray):
    """Patch-covariance matshow figures: with a diagonal covariance the
    spatially averaged patch covmat is diag(mean var per band)."""
    plt = pyplot()
    if plt is None:
        print(f"[observe] matplotlib is not installed: skipping the {mode} patch "
              "covariance figures (log_aleatoric)")
        return
    patch_diag = var.mean(axis=(1, 2, 3))         # [B, C]
    for bdx in range(min(2, patch_diag.shape[0])):
        img = np.diag(patch_diag[bdx])
        max_abs = max(abs(float(img.min())), abs(float(img.max()))) or 1.0
        for tag, lim in (("relative", max_abs), ("absolute", 0.25)):
            fig, ax = plt.subplots()
            ax.matshow(img, cmap="seismic", vmin=-lim, vmax=lim)
            ax.axis("off")
            fig.tight_layout()
            writer.add_figure(
                f"Img/{mode}/patch covmat {tag} {bdx}", fig, step)
            plt.close(fig)


def log_aleatoric(writer: Writer, cfg: Config, mode: str, step: int,
                  var: np.ndarray, name: str = "",
                  img_meter: Optional[AvgImgMetrics] = None):
    """Aleatoric-uncertainty panels. var: [B, 1, H, W, C]."""
    if cfg.loss == "MGNLL" and writer is not None:
        _patch_covmat_figures(writer, mode, step, var)

    avg_var = var.mean(axis=-1, keepdims=True)  # over bands
    flat = avg_var[0, 0].reshape(-1)
    q50 = float(np.median(flat))
    q75 = float(np.quantile(flat, 0.75))
    writer.add_image(f"Img/{mode}/{name}aleatoric [0,1]",
                     np.clip(avg_var[0, 0], 0, 1), step)
    writer.add_image(f"Img/{mode}/{name}aleatoric [0,q75]",
                     np.clip(avg_var[0, 0], 0, q75) / (q75 or 1.0), step)
    writer.add_histogram(f"Hist/{mode}/{name}aleatoric",
                         np.clip(flat, 0, 1), step)
    writer.add_scalar(f"{mode}/{name}aleatoric median all", q50, step)
    writer.add_scalar(f"{mode}/{name}aleatoric q75 all", q75, step)
    if img_meter is not None:
        vals = img_meter.value()
        if "UCE SE" in vals:
            writer.add_scalar(f"{mode}/{name}UCE SE", vals["UCE SE"], step)
            writer.add_scalar(f"{mode}/{name}AUCE SE", vals["AUCE SE"], step)


def log_train(writer: Writer, cfg: Config, step: int, batch: Dict,
              pred: np.ndarray, loss: float, var: Optional[np.ndarray] = None):
    """Periodic train logging."""
    writer.add_scalar(f"train/{cfg.loss}", loss, step)
    writer.add_scalar("train/total", loss, step)
    x, y, in_m = batch["x"], batch["y"], batch["masks"]
    if cfg.use_sar:
        writer.add_image("Img/train/in_s1", x[0][..., :1], step)
        writer.add_image("Img/train/in_s2", x[0][..., [5, 4, 3]], step)
    else:
        writer.add_image("Img/train/in_s2", x[0][..., [3, 2, 1]], step)
    writer.add_image("Img/train/out", pred[0, 0][..., [3, 2, 1]], step)
    writer.add_image("Img/train/y", y[0, 0][..., [3, 2, 1]], step)
    writer.add_image("Img/train/m", in_m[0][..., None], step)
    # cloud coverage: covered at ALL (AND) or ANY (OR) time points
    and_m = np.prod(in_m, axis=1, keepdims=True)
    or_m = np.clip(np.sum(in_m, axis=1, keepdims=True), 0, 1)
    writer.add_scalar("train/OR m %", float(or_m.mean()), step)
    writer.add_scalar("train/AND m %", float(and_m.mean()), step)
    writer.add_image("Img/train/AND m", and_m[0][..., None], step)
    writer.add_image("Img/train/OR m", or_m[0][..., None], step)
    if var is not None:
        log_aleatoric(writer, cfg, "train", step, var)


def _with_rows(loader, train: bool) -> Iterator[Dict]:
    """The loader's batches, each with ``"_rows"``: the epoch positions of its
    rows in the global sample order, i.e. the sample ids of the plot and
    export files.

    A loader sharded over data-parallel ranks (``BatchLoader(shard=(rank,
    world))``) yields this rank's strided rows of each global batch, and
    last the global tail, the same on every rank (``"_replicated_tail"``):
    that one is split here, each rank keeping its :func:`row_split`. A train
    tail too short to give every rank a row is skipped on every rank (the
    global batch norm and the gradient all-reduce need every rank in each
    step); an eval rank left without rows skips the step."""
    shard = getattr(loader, "shard", None)
    done = 0  # global rows of the batches before this one
    for batch in loader:
        tail = batch.pop("_replicated_tail", False)
        n = len(batch["y"] if "y" in batch else batch["y_dn"])
        if shard is None:
            batch["_rows"] = done + np.arange(n)
        elif tail:
            rank, world = shard
            if train and n < world:
                print(f"[loop] a train tail of {n} samples cannot give each of {world} "
                      "ranks a row: skipped on every rank")
                return
            off, cnt = row_split(n, rank, world)
            batch = shard_batch(batch, Mesh(rank, world))
            batch["_rows"] = done + off + np.arange(cnt)
        else:
            rank, world = shard
            batch["_rows"] = done + rank + world * np.arange(n)
            n *= world
        done += n
        yield batch


def _device_batches(loader, device: torch.device, prefetch: bool, train: bool = False
                    ) -> Iterator[Tuple[Dict, Dict]]:
    """Yield (host batch, device batch) over ``loader`` (:func:`_with_rows`).

    With ``prefetch`` on a CUDA device each batch is staged in pinned memory
    and copied with ``non_blocking`` on a side stream. The consumer launches
    its step without waiting for it, so when it comes back for batch i+1
    step i is still running, and the copy of batch i+1 overlaps it. The
    consumer's stream is made to wait for the copy's event, and each tensor
    is recorded on that stream so that its memory outlives the step that
    reads it. Otherwise each batch is copied on the consumer's stream from
    pageable memory, which makes the host wait for the stream at every batch
    (the plain version: the GPU check holds the prefetch against it)."""
    host_only = lambda b: {k: v for k, v in b.items() if k != "_rows"}
    side = torch.cuda.Stream(device) if prefetch and device.type == "cuda" else None
    batches = iter(_with_rows(loader, train))
    while True:
        with tracing.span("next_batch"):  # the wait on the loader
            batch = next(batches, None)
        if batch is None:
            return
        with tracing.span("to_device"):
            if side is None:
                dev = batch_to_device(host_only(batch), device)
            else:
                with torch.cuda.stream(side):
                    dev = batch_to_device(host_only(batch), device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
                stream = torch.cuda.current_stream(device)
                stream.wait_event(copied)
                for t in dev.values():
                    if isinstance(t, torch.Tensor):
                        t.record_stream(stream)
        yield batch, dev


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def step_seed(cfg: Config, step: int, rank: int = 0) -> int:
    """The dropout generator's seed for global step ``step`` on data-parallel
    rank ``rank``: a function of (cfg.rdm_seed, step, rank) alone, so a
    resumed run draws what an uninterrupted one would, and ranks draw apart."""
    return (cfg.rdm_seed * 1_000_003 + step + rank * 2 ** 40) % (2 ** 63)


def _gather_eval(losses: np.ndarray, counts: np.ndarray, rows: np.ndarray,
                 positions: np.ndarray, keys):
    """Every rank's eval results on every rank: the per-step losses as the
    global batch's (each rank's mean weighed by its rows), and the metric rows
    of all ranks in the global sample order."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (losses * counts, counts, rows, positions, list(keys)))
    wsum = sum(g[0] for g in gathered)
    n = sum(g[1] for g in gathered)
    keys = next((g[4] for g in gathered if g[4]), [])
    rows = np.concatenate([g[2] for g in gathered if g[4]], axis=1) if keys else rows
    pos = np.concatenate([g[3] for g in gathered if g[4]]) if keys else positions
    return wsum / n, rows[:, np.argsort(pos, kind="stable")], keys


def iterate(state, loader, cfg: Config, writer: Optional[Writer],
            mode: str, epoch: int, train_step=None, eval_step=None,
            generator: Optional[torch.Generator] = None,
            prefetch: bool = True) -> Tuple:
    """One epoch over ``loader``. Returns (state, metrics, img_metrics|None).

    metrics: {f'{mode}_epoch_time', f'{mode}_loss'}; for val/test also the
    averaged image metrics dict. ``train_step`` is ``make_train_step(cfg)``;
    ``eval_step`` is ``make_eval_step(cfg, with_metrics=True,
    return_outputs=...)`` and gets ``state.model``. ``generator`` is the
    attention dropout's ``torch.Generator`` on the model's device (made here
    when None); it is re-seeded every step with :func:`step_seed`.
    ``prefetch`` as in :func:`_device_batches`."""
    if len(loader) == 0:
        raise ValueError("Received data loader with zero samples!")
    device = next(state.model.parameters()).device
    if mode == "train" and generator is None:
        generator = torch.Generator(device=device)
    here = current_mesh()
    gather = active() and mode != "train"
    if active() and getattr(loader, "shard", None) != (here.rank, here.size):
        raise ValueError(f"iterate: a data-parallel run needs a loader sharded as "
                         f"(rank, world) = {(here.rank, here.size)}, got "
                         f"{getattr(loader, 'shard', None)}")

    img_meter = AvgImgMetrics()
    losses = []
    errs, errs_se, errs_ae, vars_aleatoric = [], [], [], []
    deferred_bm = []  # per-batch device metric vectors, fetched at epoch end
    n_seen = 0

    t_start = time.time()
    counts, positions = [], []  # per eval step: this rank's rows and their ids
    for i, (batch, dev) in enumerate(_device_batches(loader, device, prefetch,
                                                     mode == "train")):
        step = (epoch - 1) * len(loader) + i
        rows = batch.pop("_rows")

        if mode == "train":
            generator.manual_seed(step_seed(cfg, step, here.rank))
            state, aux = train_step(state, dev, generator)
            # the loss stays on the device: a float() here would make the
            # host wait for every step; it is fetched at the display cadence
            # and at the epoch's end
            loss = aux["loss"]
            if writer is not None and step % cfg.display_step == 0:
                pred = _host(aux["pred"])
                var = _host(aux["var"]) if "var" in aux else None
                log_train(writer, cfg, step, batch, pred, float(loss), var=var)
        else:
            if len(rows) == 0:  # a data-parallel rank without rows of the tail
                losses.append(torch.zeros((), device=device))
                counts.append(0)
                continue
            aux = eval_step(state.model, dev)
            loss = aux["loss"]  # stays on the device (fetched at epoch end)
            y = batch["y"]
            B = y.shape[0]
            counts.append(B)
            positions.append(rows)
            bm = aux.get("metrics")
            if bm is None:  # a step built without with_metrics
                has_var = cfg.loss in ("GNLL", "MGNLL") and "var" in aux
                bm = img_metrics_batch(dev["y"].float(), aux["pred"],
                                       var=aux["var"] if has_var else None)
            deferred_bm.append(bm)
            pred = var = None  # host copies, made only where a sample is due
            for bdx in range(B):
                # the sample's position in the epoch's global order: i *
                # batch_size + bdx with a tail batch's own size would collide
                # with earlier samples and overwrite their plot/export files;
                # under data parallel each id is written by the one rank
                # that holds the row
                idx = int(rows[bdx])
                do_plot = cfg.plot_every > 0 and idx % cfg.plot_every == 0
                do_export = cfg.export_every > 0 and idx % cfg.export_every == 0
                if (do_plot or do_export) and pred is None:
                    if "pred" not in aux:
                        raise ValueError(
                            "plot/export cadence hit but the eval step was "
                            "built with return_outputs=False; build it with "
                            "outputs when plot_every/export_every > 0")
                    pred = _host(aux["pred"])
                    var = _host(aux["var"]) if "var" in aux else None
                if do_plot:
                    plot_dir = os.path.join(cfg.res_dir, cfg.experiment_name,
                                            "plots", f"epoch_{epoch}", mode)
                    plot_img(batch["x"][bdx], "in", plot_dir, file_id=idx)
                    plot_img(pred[bdx], "pred", plot_dir, file_id=idx)
                    plot_img(y[bdx], "target", plot_dir, file_id=idx)
                    err_img = ((pred[bdx] - y[bdx]) ** 2).mean(-1, keepdims=True)
                    plot_img(err_img, "err", plot_dir, file_id=idx)
                    # discrete matshow of the time-mean input cloud mask
                    plot_mask(np.asarray(batch["masks"][bdx]).mean(axis=0),
                              cfg.input_t, plot_dir, file_id=idx)
                    if var is not None:
                        plot_img(var[bdx].mean(-1, keepdims=True), "var",
                                 plot_dir, file_id=idx)
                if do_export:
                    export_dir = os.path.join(cfg.res_dir, cfg.experiment_name,
                                              "export", f"epoch_{epoch}", mode)
                    export(pred[bdx], "pred", export_dir, file_id=idx)
                    export(y[bdx], "target", export_dir, file_id=idx)
                    if var is not None:
                        if cfg.loss == "MGNLL":
                            # MGNLL exports the [C,C,H,W] covariance tensor
                            # the reference's ensemble tooling consumes
                            export(diag_to_covar(var[bdx]), "covar",
                                   export_dir, file_id=idx)
                        else:
                            export(var[bdx], "var", export_dir, file_id=idx)
            n_seen += B

        losses.append(loss)

    # the epoch's scalars and metric vectors: stacked on the device, one copy
    keys = list(deferred_bm[0]) if deferred_bm else []
    packed = [torch.stack(losses).float()] if losses else []
    packed += [torch.cat([bm[k] for bm in deferred_bm]).float() for k in keys]
    host = torch.cat(packed).cpu().numpy() if packed else np.zeros(0, np.float32)
    losses, rows = host[:len(losses)], host[len(losses):].reshape(len(keys), n_seen)
    if gather:  # every rank's rows, in the global order, on every rank
        losses, rows, keys = _gather_eval(losses, np.asarray(counts, np.float64), rows,
                                          np.concatenate(positions or [np.zeros(0, int)]),
                                          keys)
    has_var_epoch = cfg.loss in ("GNLL", "MGNLL")
    n_total = rows.shape[1]  # the sample count
    for bdx in range(n_total):
        em = {k: float(rows[j, bdx]) for j, k in enumerate(keys)}
        if has_var_epoch and "mean var" in em:
            vars_aleatoric.append(em["mean var"])
            errs.append(em["error"])
            errs_se.append(em["mean se"])
            errs_ae.append(em["mean ae"])
        img_meter.add(em)
    total_time = time.time() - t_start
    print(f"Epoch time : {total_time:.1f}s")
    metrics = {f"{mode}_epoch_time": total_time,
               f"{mode}_loss": float(np.mean(losses.astype(np.float64)))}

    if mode == "train":
        return state, metrics, None

    # --- eval epoch end: scalar logs + calibration -----------------------
    last_step = epoch * len(loader)
    if writer is not None:
        for key, val in img_meter.value().items():
            if np.ndim(val) == 0 and np.isfinite(val):
                writer.add_scalar(f"{mode}/{key}", float(val), last_step)
        writer.add_scalar(f"{mode}/loss", metrics[f"{mode}_loss"], last_step)

    if cfg.loss in ("GNLL", "MGNLL") and len(vars_aleatoric) > 0:
        sorted_errors_se = compute_ece(vars_aleatoric, errs_se, n_total, percent=5)
        plot_discard(sorted_errors_se, cfg, mode, last_step, writer, is_se=True)
        uce, auce, detail = compute_uce_auce(vars_aleatoric, errs, n_total,
                                             percent=5, l2=True)
        plot_err_vs_var(detail, mode, last_step, writer, l2=True)
        img_meter["UCE SE"] = uce
        img_meter["AUCE SE"] = auce
        if writer is not None and "var" in aux:
            log_aleatoric(writer, cfg, mode, last_step,
                          _host(aux["var"]), "model/", img_meter)

    return state, metrics, img_meter.value()
