"""Dataset download / extract / arrange helper (port of
uncrtaints_tpu/cli/download.py).

Replaces the reference's util/dl_data.sh (interactive wget/tar/rsync of
per-region per-modality archives from mediaTUM). The archive manifest --
object IDs, exact file names, and archive sizes in 512-byte disk sectors --
is mirrored verbatim from dl_data.sh:60-251 (it is server-side data; the
names must match the mediaTUM objects byte-for-byte).

The tool builds a manifest, checks free disk space like dl_data.sh:255-269,
then (with --run) downloads, extracts, deletes each archive, and finally
arranges the extracted trees into the layout the dataloaders expect
(dl_data.sh:286-308):

  SEN12MSCRTS/ROIs.../<roi>/{S1,S2}/<tdx>/...   (train + test merged)
  SEN12MSCR/ROIs..._<season>_{s1,s2,s2_cloudy}/...

Without --run it prints the plan (dry-run default) -- useful on air-gapped
machines where the transfer happens elsewhere.

    python -m uncrtaints_tpu_torch.cli.download --dataset sen12mscrts \
        --splits train test --regions africa europa --dest ~/data [--run]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tarfile
from typing import Dict, List, Optional, Tuple

REGIONS = ["africa", "america", "asiaEast", "asiaWest", "europa"]
MODALITIES = ["s1", "s2"]
SEASONS = {  # season -> SEN12MS ROI collection prefix (dl_data.sh:215-250)
    "spring": "ROIs1158", "summer": "ROIs1868",
    "fall": "ROIs1970", "winter": "ROIs2017",
}

# mediaTUM object IDs (dl_data.sh URLs)
MEDIATUM = {
    "sen12mscrts_train": "1639953",
    "sen12mscrts_test": "1659251",
    "sen12mscr": "1554803",
}

# (object id, archive file name) -> archive size in 512-byte sectors,
# verbatim from dl_data.sh's vol_dict
_TS_TRAIN_SECTORS = {
    ("s2", "africa"): 98233900, ("s2", "america"): 110245004,
    ("s2", "asiaEast"): 113948560, ("s2", "asiaWest"): 96082796,
    ("s2", "europa"): 196669740,
    ("s1", "africa"): 60544524, ("s1", "america"): 67947416,
    ("s1", "asiaEast"): 70230104, ("s1", "asiaWest"): 59218848,
    ("s1", "europa"): 121213836,
}
_TS_TEST_SECTORS = {
    ("s2", "africa"): 25421744, ("s2", "america"): 25421824,
    ("s2", "asiaEast"): 40534760, ("s2", "asiaWest"): 15012924,
    ("s2", "europa"): 79568460,
    ("s1", "africa"): 15668120, ("s1", "america"): 15668160,
    ("s1", "asiaEast"): 24982736, ("s1", "asiaWest"): 9252904,
    ("s1", "europa"): 49040432,
}
_CR_SECTORS = {
    ("s2", "spring"): 48568904, ("s2", "summer"): 56425520,
    ("s2", "fall"): 68291864, ("s2", "winter"): 30580552,
    ("s2_cloudy", "spring"): 48569368, ("s2_cloudy", "summer"): 56426004,
    ("s2_cloudy", "fall"): 68292448, ("s2_cloudy", "winter"): 30580812,
    ("s1", "spring"): 15026120, ("s1", "summer"): 17456784,
    ("s1", "fall"): 21127832, ("s1", "winter"): 9460956,
}

# Standard s2cloudless LightGBM weights (publicly distributed with
# sentinel2-cloud-detector releases) -- needed by the default cloud mask
# (cloud_masks='s2cloudless_mask', dataLoader.py:145 parity).
S2CLOUDLESS_MODEL = "pixel_s2_cloud_detector_lightGBM_v0.1.txt"
S2CLOUDLESS_URL = ("https://github.com/sentinel-hub/sentinel2-cloud-detector/"
                   f"raw/master/s2cloudless/models/{S2CLOUDLESS_MODEL}")


def s2cloudless_cache_dir() -> str:
    """The port's own cache of the s2cloudless weights (data/s2cloudless.py
    searches it)."""
    return os.path.join(os.path.expanduser(
        os.environ.get("XDG_CACHE_HOME", "~/.cache")), "uncrtaints_tpu_torch")


class Archive:
    """One mediaTUM archive: its URL, exact file name, size, and where its
    extracted tree belongs."""

    def __init__(self, object_id: str, filename: str, sectors: int,
                 extract_root: str, arrange: Tuple[str, str]):
        self.object_id = object_id
        self.filename = filename          # e.g. s2_africa.tar.gz
        self.sectors = sectors            # 512-byte sectors (dl_data.sh df)
        self.extract_root = extract_root  # SEN12MSCRTS | SEN12MSCR
        # ("merge", subdir)  : rsync subdir/* into extract_root (multitemporal
        #                      train strips the s1_/s2_ prefix first,
        #                      dl_data.sh:296-300)
        # ("move", subdir)   : mv subdir into extract_root (monotemporal)
        self.arrange = arrange

    @property
    def url(self) -> str:
        return (f"https://dataserv.ub.tum.de/s/m{self.object_id}"
                f"/download?path=/&files={self.filename}")


def build_manifest(dataset: str, splits: List[str], regions: List[str],
                   modalities: List[str],
                   seasons: Optional[List[str]] = None) -> List[Archive]:
    """The archive set dl_data.sh would fetch for these choices.

    SEN12MS-CR-TS: per (split, modality, region) archives named
    ``{mod}_{region}[_test].tar.gz``. SEN12MS-CR: per (modality, season)
    archives named ``{ROIprefix}_{season}_{mod}.tar.gz`` where requesting s2
    also pulls the paired s2_cloudy archive (dl_data.sh:211-251 always
    fetches both; all regions, no split axis).
    """
    manifest: List[Archive] = []
    if dataset == "sen12mscrts":
        for split in splits:
            obj = MEDIATUM[f"sen12mscrts_{split}"]
            table = _TS_TRAIN_SECTORS if split == "train" else _TS_TEST_SECTORS
            for region in regions:
                for mod in modalities:
                    if split == "train":
                        fname = f"{mod}_{region}.tar.gz"
                        # archive extracts to e.g. 's2_africa/'; train data
                        # merges as '<region>/*' after the prefix strip
                        arrange = ("merge", region)
                    else:
                        fname = f"{mod}_{region}_test.tar.gz"
                        arrange = ("merge", f"{mod}_{region}_test")
                    manifest.append(Archive(obj, fname, table[(mod, region)],
                                            "SEN12MSCRTS", arrange))
    elif dataset == "sen12mscr":
        mods = []
        for mod in modalities:
            mods.append(mod)
            if mod == "s2":
                mods.append("s2_cloudy")
        for season in (seasons or list(SEASONS)):
            prefix = SEASONS[season]
            for mod in mods:
                fname = f"{prefix}_{season}_{mod}.tar.gz"
                manifest.append(Archive(
                    MEDIATUM["sen12mscr"], fname, _CR_SECTORS[(mod, season)],
                    "SEN12MSCR", ("move", f"{prefix}_{season}_{mod}")))
    else:
        raise ValueError(dataset)
    return manifest


def required_sectors(manifest: List[Archive]) -> int:
    return sum(a.sectors for a in manifest)


def available_sectors(path: str) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize // 512


def check_disk_space(manifest: List[Archive], dest: str) -> None:
    """dl_data.sh:255-269: refuse when the destination cannot hold the
    archives (512-byte sector accounting, like its `df` check)."""
    req = required_sectors(manifest)
    avail = available_sectors(dest)
    if avail < req:
        raise RuntimeError(
            f"Not enough space (512-byte disk sectors) on path {dest}. "
            f"Available {avail}. Required {req}")
    print(f"Consuming {req} of {avail} (512-byte disk sectors) on {dest}")


def fetch_steps(manifest: List[Archive], dest: str) -> List[tuple]:
    """Download -> extract -> delete-archive, per archive
    (dl_data.sh:274-283), then arrange trees into place (:286-308)."""
    steps: List[tuple] = []
    roots = sorted({a.extract_root for a in manifest})
    for root in roots:
        steps.append(("mkdir", os.path.join(dest, root)))
    for a in manifest:
        out = os.path.join(dest, a.filename)
        steps.append(("download", a.url, out))
        steps.append(("extract", out, dest))
        steps.append(("rm", out))
    for a in manifest:
        kind, subdir = a.arrange
        steps.append((kind, os.path.join(dest, subdir),
                      os.path.join(dest, a.extract_root)))
    return steps


def _merge_tree(src: str, dst: str) -> None:
    """rsync -a --remove-source-files src/* dst + rm -rf src: merge ROI
    subtrees that may already partially exist (train + test share ROIs)."""
    if not os.path.isdir(src):
        return
    for name in os.listdir(src):
        s, d = os.path.join(src, name), os.path.join(dst, name)
        if os.path.isdir(s) and os.path.isdir(d):
            _merge_tree(s, d)
        else:
            os.makedirs(os.path.dirname(d), exist_ok=True)
            shutil.move(s, d)
    shutil.rmtree(src, ignore_errors=True)


def run_step(step: tuple) -> None:
    kind = step[0]
    if kind == "mkdir":
        os.makedirs(step[1], exist_ok=True)
    elif kind == "download":
        subprocess.run(["wget", "--no-check-certificate", "-c",
                        "-O", step[2], step[1]], check=True)
    elif kind == "extract":
        with tarfile.open(step[1]) as tf:
            # the "data" filter refuses members that would land outside step[2]
            tf.extractall(step[2], filter="data")
    elif kind == "rm":
        if os.path.exists(step[1]):
            os.remove(step[1])
    elif kind == "merge":
        _merge_tree(step[1], step[2])
    elif kind == "move":
        if os.path.exists(step[1]):
            shutil.move(step[1], step[2])
    else:
        raise ValueError(kind)


def format_step(step: tuple) -> str:
    kind = step[0]
    if kind == "download":
        return f"wget --no-check-certificate -c -O {step[2]} '{step[1]}'"
    if kind == "extract":
        return f"tar --extract --file {step[1]} -C {step[2]}"
    if kind == "rm":
        return f"rm {step[1]}"
    if kind == "mkdir":
        return f"mkdir -p {step[1]}"
    if kind == "merge":
        return f"rsync -a --remove-source-files {step[1]}/* {step[2]} && rm -rf {step[1]}"
    if kind == "move":
        return f"mv {step[1]} {step[2]}"
    raise ValueError(kind)


def create_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="sen12mscrts",
                   choices=["sen12mscrts", "sen12mscr"])
    p.add_argument("--splits", nargs="+", default=["train"],
                   choices=["train", "test"])
    p.add_argument("--regions", nargs="+", default=REGIONS,
                   choices=REGIONS + ["all"])
    p.add_argument("--modalities", nargs="+", default=MODALITIES,
                   choices=MODALITIES)
    p.add_argument("--seasons", nargs="+", default=list(SEASONS),
                   choices=list(SEASONS), help="sen12mscr only")
    p.add_argument("--dest", default="./data", type=str)
    p.add_argument("--run", action="store_true",
                   help="execute the plan instead of printing it")
    p.add_argument("--skip_space_check", action="store_true")
    p.add_argument("--s2cloudless-weights", dest="s2cloudless_weights",
                   action="store_true",
                   help="fetch ONLY the standard s2cloudless LightGBM model "
                        "file into the cache dir (needed by the default "
                        "cloud_masks='s2cloudless_mask')")
    return p


def main(args):
    if getattr(args, "s2cloudless_weights", False):
        out = os.path.join(s2cloudless_cache_dir(), S2CLOUDLESS_MODEL)
        step = ("download", S2CLOUDLESS_URL, out)
        print(format_step(step))
        if args.run:
            os.makedirs(s2cloudless_cache_dir(), exist_ok=True)
            run_step(step)
        return
    regions = REGIONS if "all" in args.regions else args.regions
    manifest = build_manifest(args.dataset, args.splits, regions,
                              args.modalities, seasons=args.seasons)
    dest = os.path.expanduser(args.dest)
    if args.run:
        # only an actual download needs local space / the dest dir;
        # a dry-run plan must print anywhere (air-gapped planning hosts)
        os.makedirs(dest, exist_ok=True)
        if not args.skip_space_check:
            check_disk_space(manifest, dest)
    steps = fetch_steps(manifest, dest)
    for step in steps:
        print(format_step(step))
        if args.run:
            run_step(step)
    if not args.run:
        print("\n(dry run -- pass --run to execute)")


def cli_main():
    """Console entry point (pyproject: uncrtaints-torch-download)."""
    main(create_parser().parse_args())


if __name__ == "__main__":
    cli_main()
