"""Precompute per-patch cloud-coverage statistics (and optionally sampled
date indices) so training avoids reading all 30 frames per sample (port of
uncrtaints_tpu/cli/precompute.py).

As the reference's util/pre_compute_data_samples.py:46-128: iterate
the generic dataset once, export
``{pdx: {'coverage': [...], 'input': [...], 'target': k, 'paths': {...}}}``
to ``generic_{t}_{split}_{region}_{mask}.npy``, and report the grand-average
S2 variance (used to sanity-check radiometry). The masks run on
``--device`` ("cuda" by default; without a card it raises).

    python -m uncrtaints_tpu_torch.cli.precompute --root ~/data/SEN12MSCRTS \
        --split train --region all --input_t 3 --cloud_masks cloud_cloudshadow_mask
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def create_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, type=str)
    p.add_argument("--split", default="train", type=str)
    p.add_argument("--region", default="all", type=str)
    p.add_argument("--input_t", default=3, type=int)
    p.add_argument("--cloud_masks", default="s2cloudless_mask", type=str)
    p.add_argument("--out_dir", default="precomputed", type=str)
    p.add_argument("--sample_dates", action="store_true",
                   help="also export fixed-sampler date indices per patch")
    p.add_argument("--vary", default=1, type=int,
                   help="number of passes (reference uses 30 for 'random')")
    p.add_argument("--device", default="cuda", type=str,
                   help="where the cloud masks run (default the card)")
    return p


def main(args) -> str:
    from uncrtaints_tpu_torch.data.samplers import fixed_sampler
    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS

    ds = SEN12MSCRTS(args.root, split=args.split, region=args.region,
                     sample_type="generic", cloud_masks=args.cloud_masks,
                     n_input_samples=args.input_t, device=args.device)
    print(f"Indexed {len(ds)} patches; computing statistics "
          f"(one process; the masks run on {ds.device}).")

    data_pairs = {}
    var_sum, var_n = 0.0, 0
    t0 = time.time()
    for pdx in range(len(ds)):
        sample = ds[pdx]
        coverage = [float(c) for c in sample["coverage"]]
        entry = {"coverage": np.asarray(coverage, np.float32),
                 "paths": {"S1": sample["S1 path"], "S2": sample["S2 path"]}}
        if args.sample_dates:
            inputs_idx, cloudless_idx, _ = fixed_sampler(
                coverage, args.input_t)
            entry["input"], entry["target"] = inputs_idx, cloudless_idx
        data_pairs[pdx] = entry
        for img in sample["S2"]:
            var_sum += float(np.var(img))
            var_n += 1
        if pdx % 50 == 0:
            print(f"  {pdx}/{len(ds)}  elapsed {time.time()-t0:.1f}s")

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(
        args.out_dir,
        f"generic_{args.input_t}_{args.split}_{args.region}_{args.cloud_masks}.npy")
    np.save(out, data_pairs, allow_pickle=True)
    if var_n:
        print(f"Grand average S2 variance: {var_sum / var_n:.6f}")
    took = time.time() - t0
    print(f"Wrote {out} in {took:.1f}s ({len(ds) / max(took, 1e-9):.2f} patches/s)")
    return out


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-precompute)."""
    main(create_parser().parse_args())


if __name__ == "__main__":
    cli_main()
