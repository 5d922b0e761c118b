"""tif -> HDF5 dataset converter CLI (port of uncrtaints_tpu/cli/convert.py).

Replaces the reference's util/hdf5converter/ (script_tif2hdf5.sh and the
SEN12MSCRTS_to_hdf5 exporter). Run once; the HDF5 source then serves the
samples. GDAL/rasterio is used when installed, else the port's codec
(data/tiff.py). The masks run on ``--device`` ("cuda" by default).

    python -m uncrtaints_tpu_torch.cli.convert --root ~/data/SEN12MSCRTS \
        --split train --region all --cloud_masks cloud_cloudshadow_mask --out train.h5
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None, type=str,
                   help="dataset root (required unless --synthetic_data)")
    p.add_argument("--split", default="train", type=str)
    p.add_argument("--region", default="all", type=str)
    p.add_argument("--cloud_masks", default="s2cloudless_mask", type=str)
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--max_patches", default=None, type=int)
    p.add_argument("--synthetic_data", action="store_true",
                   help="convert the synthetic source (tests/demo)")
    p.add_argument("--device", default="cuda", type=str,
                   help="where the cloud masks run (default the card)")
    return p


def main(args) -> str:
    from uncrtaints_tpu_torch.data.hdf5 import convert_to_hdf5

    if not args.synthetic_data and not args.root:
        raise SystemExit("--root is required unless --synthetic_data is set")

    if args.synthetic_data:
        # synthetic generic-mode stand-in: full series per patch
        from uncrtaints_tpu_torch.data.synthetic import SyntheticSEN12MSCRTS

        class _Generic(SyntheticSEN12MSCRTS):
            def __getitem__(self, pdx):
                s = super().__getitem__(pdx)
                return {"S1": s["input"]["S1"], "S2": s["input"]["S2"],
                        "masks": s["input"]["masks"],
                        "coverage": s["input"]["coverage"],
                        "S1 TD": s["input"]["S1 TD"],
                        "S2 TD": s["input"]["S2 TD"]}
        ds = _Generic(n_samples=args.max_patches or 8, n_input_t=4,
                      patch_size=256)
    else:
        from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS
        ds = SEN12MSCRTS(args.root, split=args.split, region=args.region,
                         sample_type="generic", cloud_masks=args.cloud_masks,
                         device=args.device)
    out = convert_to_hdf5(ds, args.out, max_patches=args.max_patches)
    print(f"Wrote {out} ({len(ds)} patches)")
    return out


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-convert)."""
    main(create_parser().parse_args())


if __name__ == "__main__":
    cli_main()
