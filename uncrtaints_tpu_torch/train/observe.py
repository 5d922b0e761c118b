"""Observability: TensorBoard scalars/images/histograms + file artifacts.

Port of uncrtaints_tpu/train/observe.py: scalar losses and lr, cloud coverage
AND/OR statistics, input/pred/target/mask image panels, variance images,
histograms, discard and calibration figures.

Backend: ``torch.utils.tensorboard.SummaryWriter`` when it imports, else a
JSONL + file fallback so that headless training never loses logs: scalars go
to scalars.jsonl, and images, figures and histograms are written as PNG or
NPY files under {logdir}/media/ with an index line in the JSONL. Events land
in {res_dir}/../logs/{experiment}.

matplotlib is imported inside the functions that draw. Where it is missing,
the fallback's ``add_image`` saves the raw array, the epoch-end figures
(``plot_discard``, ``plot_err_vs_var``) print one line naming what they skip
and return, and ``plot_img`` / ``plot_mask`` raise: the CLIs refuse
``plot_every > 0`` at start (:func:`require_matplotlib`). No number of a
metrics file depends on matplotlib.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def require_matplotlib(what: str):
    """pyplot, or an ImportError that names what asked for it (the CLIs call
    it at the start of a run that asks for drawn files)."""
    plt = pyplot()
    if plt is None:
        raise ImportError(f"{what} needs matplotlib, which is not installed; "
                          "set plot_every to -1 to run without the image panels")
    return plt


def _skip(what: str):
    print(f"[observe] matplotlib is not installed: skipping {what}")


class Writer:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
            print(f"[observe] tensorboard is not installed: logging to {logdir}/scalars.jsonl "
                  "and media/")
        else:
            self._writer = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": value, "step": step}) + "\n")
            self._jsonl.flush()

    def _media_path(self, tag: str, step: int, ext: str) -> str:
        """Path for a fallback media artifact + an index line in the JSONL
        (tags contain '/', sanitized to one flat path-safe filename)."""
        safe = "".join(c if (c.isalnum() or c in "._-") else "_"
                       for c in tag)
        d = os.path.join(self.logdir, "media")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{safe}_step-{step}.{ext}")
        self._jsonl.write(json.dumps(
            {"tag": tag, "step": step, "file": os.path.relpath(
                path, self.logdir)}) + "\n")
        self._jsonl.flush()
        return path

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int):
        """img_hwc: [H, W, C] float in [0, 1] (or [N, H, W, C])."""
        img = np.asarray(img_hwc, np.float32)
        if img.ndim == 3:
            img = img[None]
        img = np.clip(img, 0, 1)
        if self._writer is not None:
            self._writer.add_images(tag, img, step, dataformats="NHWC")
            return
        panel = img[0]
        plt = pyplot()
        if plt is None:
            # neither tensorboard nor matplotlib: keep the raw array
            np.save(self._media_path(tag, step, "npy"), panel)
            return
        plt.imsave(self._media_path(tag, step, "png"),
                   panel.squeeze(-1) if panel.shape[-1] == 1 else panel,
                   cmap="gray", vmin=0, vmax=1)

    def add_histogram(self, tag: str, values, step: int, bins: int = 256):
        if self._writer is None:
            np.save(self._media_path(tag, step, "npy"), np.asarray(values))
            return
        self._writer.add_histogram(tag, np.asarray(values), step, bins=bins)

    def add_figure(self, tag: str, fig, step: int):
        """Render a matplotlib figure to an image summary."""
        if self._writer is None:
            fig.savefig(self._media_path(tag, step, "png"),
                        format="png", dpi=100)
            return
        self._writer.add_figure(tag, fig, step, close=False)

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()


# ----------------------- file artifacts ------------------------------ #

def plot_img(imgs, mod: str, plot_dir: str, file_id=None):
    """Export RGB/gray PNG panels. imgs: [T, H, W, C] NHWC."""
    plt = require_matplotlib("plot_img")
    os.makedirs(plot_dir, exist_ok=True)
    imgs = np.asarray(imgs)
    for tdx, img in enumerate(imgs):
        suffix = "" if imgs.shape[0] == 1 else f"_t-{tdx}"
        if mod in ("pred", "in", "target", "s2"):
            rgb = [3, 2, 1] if img.shape[-1] == 13 else [5, 4, 3]
            img, vmin, vmax = img[..., rgb], 0, 1
        elif mod in ("s1", "mask"):
            img, vmin, vmax = img[..., [0]], 0, 1
        elif mod == "err":
            img, vmin, vmax = img[..., [0]], 0, 0.01
        elif mod == "var":
            img, vmin, vmax = img[..., [0]], 0, 0.000025
        else:
            raise NotImplementedError(mod)
        if file_id is not None:
            img = np.clip(img, vmin, vmax)
            plt.imsave(os.path.join(plot_dir, f"img-{file_id}_{mod}{suffix}.png"),
                       img.squeeze(), dpi=100, cmap="gray",
                       vmin=vmin, vmax=vmax)
    plt.close("all")


def plot_mask(mean_mask_hw, n_colors: int, plot_dir: str, file_id):
    """The eval `mask` panel: a discrete-gray matshow of the input cloud
    masks averaged over time (n_colors = input_t, so each gray level is
    'cloudy in k of T frames'). Saved as img-{id}_mask.png next to the other
    panels."""
    plt = require_matplotlib("plot_mask")
    os.makedirs(plot_dir, exist_ok=True)
    fig, ax = plt.subplots()
    cmap = plt.get_cmap("gray", n_colors + 1)
    ax.matshow(np.asarray(mean_mask_hw), cmap=cmap, vmin=0, vmax=1)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"img-{file_id}_mask.png"), dpi=100)
    plt.close(fig)


def export(arrs, mod: str, export_dir: str, file_id=None):
    """NPY export per temporal slice. Exports are CHW on disk, the layout
    the reference's ensemble tooling reads."""
    os.makedirs(export_dir, exist_ok=True)
    arrs = np.asarray(arrs)
    for tdx, arr in enumerate(arrs):
        num = "" if arrs.shape[0] == 1 else f"_t-{tdx}"
        np.save(os.path.join(export_dir, f"img-{file_id}_{mod}{num}.npy"),
                np.moveaxis(arr, -1, 0) if arr.ndim == 3 else arr)


def diag_to_covar(var) -> np.ndarray:
    """[T, H, W, C] diagonal variance -> [T, C, C, H, W] covariance tensor.

    With MGNLL the reference exports per-sample ``img-{i}_covar.npy`` tensors
    of shape [C, C, H, W], which its ensemble tooling consumes by taking the
    diagonal. The compact diagonal stays on the device and is expanded only
    at export time."""
    v = np.moveaxis(np.asarray(var), -1, 1)          # [T, C, H, W]
    t, c = v.shape[0], v.shape[1]
    out = np.zeros((t, c, c) + v.shape[2:], v.dtype)
    idx = np.arange(c)
    out[:, idx, idx] = v
    return out


def plot_discard(sorted_errors: np.ndarray, cfg, mode: str, step: int,
                 writer: Optional[Writer] = None, is_se: bool = True):
    """Discard curve + linear fit."""
    metric = "SE" if is_se else "AE"
    plt = pyplot()
    if plt is None:
        return _skip(f"the {mode} {metric} discard curve (plot_discard)")
    fig, ax = plt.subplots()
    x_axis = np.arange(0.0, 1.0, 0.05)
    se = np.array(sorted_errors, dtype=np.float64)
    ax.scatter(x_axis, se, c="b", marker=".",
               label=f"{metric}, sorted by uncertainty")
    se[np.isnan(se)] = np.nanmean(se)
    b, a = np.polyfit(x_axis, se, deg=1)
    xs = np.linspace(0, 1.0, 1000)
    ax.plot(xs, a + b * xs, c="k", lw=1.5, alpha=0.75,
            label=f"linear fit, {round(a, 3)} + {round(b, 3)} * x")
    plt.xlabel("Fraction of samples, sorted ascendingly by uncertainty")
    plt.ylabel("Error")
    plt.legend(loc="upper left")
    plt.grid()
    fig.tight_layout()
    if writer is not None:
        writer.add_figure(f"Img/{mode}/discard_uncertain", fig, step)
    if mode == "test":
        path_to = os.path.join(cfg.res_dir, cfg.experiment_name)
        os.makedirs(path_to, exist_ok=True)
        fig.savefig(os.path.join(path_to, f"plot_{mode}_{metric}_discard.png"),
                    bbox_inches="tight", dpi=1000)
        fig.savefig(os.path.join(path_to, f"plot_{mode}_{metric}_discard.pdf"),
                    bbox_inches="tight", dpi=1000)
    plt.close(fig)


def plot_err_vs_var(detail: dict, mode: str, step: int,
                    writer: Optional[Writer] = None, l2: bool = True):
    """Bin-wise error vs uncertainty bars."""
    plt = pyplot()
    if plt is None:
        return _skip(f"the {mode} error-vs-uncertainty bars (plot_err_vs_var)")
    bk_var, bk_err = detail["bk_var"], detail["bk_err"]
    ok = ~np.isnan(bk_var)
    if not ok.any():
        return
    n_bins = len(bk_var)
    x_min, x_max = np.nanmin(bk_var), np.nanmax(bk_var)
    x_axis = np.linspace(x_min, x_max, num=n_bins)
    fig, ax = plt.subplots()
    ax.plot(x_axis, x_axis)
    ax.bar(x_axis, np.nan_to_num(bk_err), width=(x_axis[1] - x_axis[0]) or 1,
           alpha=0.75, edgecolor="k", color="gray")
    plt.xlabel("Uncertainty")
    plt.ylabel(f"{'L2' if l2 else 'L1'} Error")
    plt.grid()
    fig.tight_layout()
    if writer is not None:
        writer.add_figure(f"Img/{mode}/err_vs_var_{'L2' if l2 else 'L1'}", fig, step)
    plt.close(fig)
