"""Offline deep-ensemble fusion for epistemic uncertainty.

Port of uncrtaints_tpu/cli/ensemble.py. Each member's test-split
predictions are first exported by ``cli.test --export_every 1``; this tool
loads every member's pred and covar / var arrays per sample, fuses them by
moment matching of a uniform Gaussian mixture and evaluates the calibrated
metrics on ``--device`` ("cuda" by default; without a card it raises, it
never moves to the CPU):

    mean = sum_i mu_i / n
    var  = aleatoric: sum_i var_i / n
           epistemic: sum_i mu_i^2 / n - mean^2
           both:      sum_i (var_i + mu_i^2) / n - mean^2

    python -m uncrtaints_tpu_torch.cli.ensemble --root ~/data --mode test \\
        --members inference/diag_1 inference/diag_2 inference/diag_3 \\
        --uncertainty both --epoch 1
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from uncrtaints_tpu_torch.data.sen12mscrts import natsorted
from uncrtaints_tpu_torch.metrics import AvgImgMetrics, compute_uce_auce, img_metrics
from uncrtaints_tpu_torch.train.observe import export


def create_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="/home/data", type=str)
    p.add_argument("--mode", default="test", type=str)
    p.add_argument("--in_time", default=3, type=int)
    p.add_argument("--region", default="all", type=str)
    p.add_argument("--max_samples", default=int(1e9), type=int)
    p.add_argument("--uncertainty", default="both",
                   choices=["aleatoric", "epistemic", "both"])
    p.add_argument("--no-ensemble", dest="ensemble", action="store_false")
    p.add_argument("--pixelwise", dest="pixelwise", action="store_true", default=True)
    p.add_argument("--export_path", default=None, type=str)
    p.add_argument("--members", nargs="+", required=True,
                   help="export dirs of each member (epoch/mode resolved inside)")
    p.add_argument("--epoch", default=1, type=int)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--cloud_masks", default="s2cloudless_mask", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="where the metrics (and a real dataset's cloud masks) run")
    return p


def member_dir(base: str, epoch: int, mode: str) -> str:
    d = os.path.join(base, "export", f"epoch_{epoch}", mode)
    return d if os.path.isdir(d) else base


def load_member_arrays(paths: List[str], sample_name: str):
    """Each member's pred and covar | var of one sample, stacked: ([n, C, H,
    W], [n, C, H, W]); (None, None) if a member lacks either. A covariance
    export [C, C, H, W] (the MGNLL format) is reduced to its diagonal, so
    members exporting covar and members exporting var stack together."""
    means, variances = [], []
    for p in paths:
        mp = os.path.join(p, sample_name)
        if not os.path.isfile(mp):
            return None, None
        means.append(np.load(mp))
        vp = mp.replace("_pred", "_covar")
        if not os.path.isfile(vp):
            vp = mp.replace("_pred", "_var")
        if not os.path.isfile(vp):
            return None, None
        v = np.load(vp)
        if v.ndim == 4 and v.shape[0] == v.shape[1]:   # [C, C, H, W]
            v = np.moveaxis(np.diagonal(v, axis1=0, axis2=1), -1, 0)
        variances.append(v)
    return np.array(means), np.array(variances)


def fuse(mean: np.ndarray, var: np.ndarray, uncertainty: str):
    """Moment matching of the members' [n, ...] means and variances."""
    n = mean.shape[0]
    mean_ens = mean.sum(axis=0) / n
    if uncertainty == "aleatoric":
        var_ens = var.sum(axis=0) / n
    elif uncertainty == "epistemic":
        var_ens = (mean ** 2).sum(axis=0) / n - mean_ens ** 2
    elif uncertainty == "both":
        var_ens = (var + mean ** 2).sum(axis=0) / n - mean_ens ** 2
    else:
        raise NotImplementedError(uncertainty)
    return mean_ens, var_ens


def build_target_dataset(args):
    """The target dataset, built once (building it per sample would index
    the whole directory tree again for every prediction)."""
    if args.synthetic_data:
        from uncrtaints_tpu_torch.data.synthetic import SyntheticSEN12MSCRTS
        return SyntheticSEN12MSCRTS(n_samples=args.max_samples if args.max_samples < 1e9 else 64,
                                    n_input_t=args.in_time, patch_size=256, seed=3)
    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS
    return SEN12MSCRTS(os.path.join(args.root, "SEN12MSCRTS"), split=args.mode,
                       region=args.region, sample_type="cloudy_cloudfree",
                       cloud_masks=args.cloud_masks, n_input_samples=args.in_time,
                       device=args.device)


def get_target(ds, idx: int) -> np.ndarray:
    """Target S2 frame of the idx-th sample as [1, H, W, 13]."""
    s = ds[idx]
    return np.moveaxis(np.asarray(s["target"]["S2"][0]), 0, -1)[None]


def main(args) -> dict:
    paths = [member_dir(m, args.epoch, args.mode) for m in args.members]
    print("Ensembling over model predictions:")
    for p in paths:
        print(" ", p)

    samples = natsorted(f for f in os.listdir(paths[0]) if "_pred" in f
                        and f.endswith(".npy") and "_t-" not in f)
    ds = build_target_dataset(args)
    # every exported prediction must have a target to compare against
    n_eval = min(len(samples), args.max_samples)
    assert len(ds) >= n_eval, (
        f"{len(samples)} exported predictions but target dataset has only "
        f"{len(ds)} samples -- export/dataset mismatch")
    device = torch.device(args.device)
    on_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    img_meter = AvgImgMetrics()
    vars_aleatoric, errs, errs_se, errs_ae = [], [], [], []

    for idx, name in enumerate(samples):
        if idx >= args.max_samples:
            break
        mean, var = load_member_arrays(paths, name)
        if mean is None:
            print(f"Skipped sample {idx}, missing data.")
            continue
        if args.ensemble:
            mean_e, var_e = fuse(mean, var, args.uncertainty)
        else:
            mean_e, var_e = mean[0], var[0]

        y = get_target(ds, idx)
        # exports are CHW; metrics are NHWC
        mean_hwc = np.moveaxis(mean_e, 0, -1)[None]
        var_hwc = np.moveaxis(var_e, 0, -1)[None]
        em = img_metrics(on_device(y), on_device(mean_hwc), var=on_device(var_hwc),
                         pixelwise=args.pixelwise)
        img_meter.add(em)
        if args.pixelwise:
            vars_aleatoric.extend(em["pixelwise var"])
            errs.extend(em["pixelwise error"])
            errs_se.extend(em["pixelwise se"])
            errs_ae.extend(em["pixelwise ae"])
        else:
            vars_aleatoric.append(em["mean var"])
            errs.append(em["error"])
            errs_se.append(em["mean se"])
            errs_ae.append(em["mean ae"])

        if args.export_path:
            ed = os.path.join(args.export_path, "export", f"epoch_{args.epoch}", args.mode)
            export(mean_hwc, "pred", ed, file_id=idx)
            export(var_hwc, "var", ed, file_id=idx)

    uce, auce, _ = compute_uce_auce(vars_aleatoric, errs, len(vars_aleatoric),
                                    percent=5, l2=True)
    img_meter["UCE SE"] = uce
    img_meter["AUCE SE"] = auce
    print(f"{args.mode} split image metrics: {img_meter.value()}")
    if args.export_path:
        os.makedirs(args.export_path, exist_ok=True)
        np.save(os.path.join(args.export_path, f"pred_var_{args.uncertainty}.npy"),
                vars_aleatoric)
        np.save(os.path.join(args.export_path, "errors.npy"), errs)
    return img_meter.value()


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-ensemble)."""
    main(create_parser().parse_args())


if __name__ == "__main__":
    cli_main()
