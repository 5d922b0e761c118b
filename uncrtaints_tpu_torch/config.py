"""Configuration & CLI flag system.

The port's own copy of uncrtaints_tpu/config.py: the same names, defaults
and derived rules (the tests hold ``derive`` of the two equal on the shared
fields), so a conf.json written by either package loads in the other
(``from_dict`` ignores unknown keys). Differences: ``device`` defaults to
"cuda"; ``fused_eval`` has the port's meaning (models/registry.py: auto = on
for a CUDA device); ``remat`` recomputes each UnCRtainTS block in the
backward (``torch.utils.checkpoint``, models/uncrtaints.py) and
``debug_nans`` stops the step that made a NaN (cli/train.py). ``prng_impl``
is not carried: it picks the JAX PRNG algorithm (threefry or rbg) for the
dropout noise, and the port draws that noise from a ``torch.Generator``,
whose algorithm CUDA offers no choice of.

``ckpt_backend`` "msgpack" (the default) means the package's single-file
format, the reference's ``.pth.tar``, and "orbax" its asynchronous
counterpart, a ``torch.distributed.checkpoint`` directory (train/checkpoint.py).
Either way the loads also read the JAX package's single-file ``.ckpt``
(flax msgpack), not its ``.orbax`` directories.
``mesh_shape`` is the number of data-parallel ranks, one process per GPU
(parallel/mesh.py).

Flag-for-flag parity with the reference argparse parser (parse_args.py:5-95)
and the post-parse derived-rule pass (train_reconstruct.py:36-84), on a
dataclass so library users get a typed config while CLI users keep the exact
flag surface.

Reference quirks preserved on purpose:
- ``--mean_nonLinearity``, ``--positional_encoding`` and ``--vary_samples``
  are *store_false* flags: passing them DISABLES the feature
  (parse_args.py:31,43,72).
- GNLL forces covmode='uni'; iso adds +1 output channel, uni/diag add
  +S2_BANDS and force a softplus variance nonlinearity
  (train_reconstruct.py:53-61).
- unet/utae force loss='l2'; unet implies pretraining from scratch
  (train_reconstruct.py:39-45).
- pretraining is mono-temporal: input_t=n_head=1, sample_type='pretrain',
  no positional encoding; batch 32 for unet (train_reconstruct.py:47-51).
- resume merges conf.json with a no-overwrite list and rescales lr by
  gamma**resume_at (train_reconstruct.py:66-84).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

S2_BANDS = 13

# flags that must never be overwritten when re-loading a train-time conf.json
NO_OVERWRITE_RESUME = [
    "pid", "num_workers", "root1", "root2", "root3", "resume_from",
    "trained_checkp", "epochs", "encoder_widths", "decoder_widths", "lr",
]
# reference test_reconstruct.py:47-48
NO_OVERWRITE_TEST = [
    "pid", "device", "resume_at", "trained_checkp", "res_dir", "weight_folder",
    "root1", "root2", "root3", "max_samples_count", "batch_size", "display_step",
    "plot_every", "export_every", "input_t", "region", "min_cov", "max_cov",
    # host-runtime knob, not a model property: --no_fast_collate at test
    # time must win over the stored train-time conf.json
    "fast_collate",
    # a test-time choice: the stored run was trained without it, so the
    # reference's list, which lacks it, drops the flag given on the command line
    "use_custom",
    # run-time choices of the test run itself (the port's cli.test honours
    # them): its rank count, its trace and its FLOP count, not the train run's
    "mesh_shape", "trace_dir", "profile",
]


def _parse_int_list(v) -> List[int]:
    """Map '[128,128]' or '128,128' (or an actual list) to a list of ints.

    Mirrors src/utils.py:10-16 (str2list)."""
    if v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    v = str(v).replace("[", "").replace("]", "")
    return [int(x) for x in v.split(",")]


@dataclass
class Config:
    """Typed mirror of the reference's argparse namespace."""

    # model parameters
    model: str = "uncrtaints"
    experiment_name: str = "my_first_experiment"
    res_dir: str = "./results"
    plot_every: int = -1
    export_every: int = -1
    resume_at: int = 0
    encoder_widths: List[int] = field(default_factory=lambda: [128])
    decoder_widths: List[int] = field(default_factory=lambda: [128, 128, 128, 128, 128])
    out_conv: List[int] = field(default_factory=lambda: [S2_BANDS])
    mean_nonLinearity: bool = True       # store_false flag
    var_nonLinearity: str = "softplus"
    agg_mode: str = "att_group"
    encoder_norm: str = "group"
    decoder_norm: str = "batch"
    block_type: str = "mbconv"
    padding_mode: str = "reflect"
    pad_value: float = 0.0

    # attention-specific parameters
    n_head: int = 16
    d_model: int = 256
    positional_encoding: bool = True     # store_false flag
    d_k: int = 4
    low_res_size: int = 32
    use_v: bool = False

    # set-up parameters
    num_workers: int = 0
    rdm_seed: int = 1
    device: str = "cuda"
    display_step: int = 10

    # training parameters
    loss: str = "MGNLL"
    resume_from: bool = False
    unfreeze_after: int = 0
    epochs: int = 20
    batch_size: int = 4
    chunk_size: Optional[int] = None     # accepted for parity; unused
    lr: float = 1e-2
    gamma: float = 1.0
    val_every: int = 1
    val_after: int = 0

    # SEN12MS-CR / SEN12MS-CR-TS flags
    use_sar: bool = False
    pretrain: bool = False
    input_t: int = 3
    ref_date: str = "2014-04-03"
    sample_type: str = "cloudy_cloudfree"
    vary_samples: bool = True            # store_false flag
    min_cov: float = 0.0
    max_cov: float = 1.0
    root1: str = "/home/data/SEN12MSCRTS"
    root2: str = "/home/data/SEN12MSCRTS"
    root3: str = "/home/data/SEN12MSCR"
    precomputed: str = "util/precomputed"
    region: str = "all"
    max_samples_count: int = int(1e9)
    max_samples_frac: float = 1.0
    profile: bool = False
    trained_checkp: str = ""

    # uncertainty flags
    covmode: str = "diag"
    scale_by: float = 1.0
    separate_out: bool = False

    # testing flags
    weight_folder: str = "./results"
    use_custom: bool = False
    load_config: str = ""

    # additions of the JAX package (absent in the reference; safe defaults)
    mesh_shape: Optional[int] = None     # number of data-parallel devices; None = all
    compute_dtype: str = "bfloat16"      # matmul/conv compute dtype
    cloud_masks: str = "s2cloudless_mask"  # reference default (dataLoader.py:145);
                                         # the ML detector needs the standard
                                         # LightGBM weights on disk -- fetch via
                                         # `cli.download --s2cloudless-weights`
                                         # or pass cloud_cloudshadow_mask for
                                         # the on-device threshold detector
    synthetic_data: bool = False         # use the synthetic data source (tests/bench)
    synthetic_patch: int = 256           # synthetic patch size; shrink for
                                         # CPU smoke runs
    fast_collate: bool = True            # single-pass native batch assembly
                                         # (exact numerics; auto-falls back
                                         # to the numpy collate when the
                                         # native lib or uniform T is absent)
    remat: bool = False                  # rematerialize conv blocks (memory<->FLOPs):
                                         # torch.utils.checkpoint of each
                                         # UnCRtainTS block in training
    accum_steps: int = 1                 # gradient accumulation: split the
                                         # batch into this many microbatches,
                                         # one optimizer update
                                         # on the mean gradient
    ckpt_backend: str = "msgpack"        # checkpoint format: msgpack (single
                                         # .pth.tar, reference-style) | orbax
                                         # (async .dcp directory, atomic)
    debug_nans: bool = False             # fault isolation: anomaly detection and
                                         # a NaN check of every module's output
    trace_dir: str = ""                  # profiler trace output directory
    fused_eval: str = "auto"             # fused eval MBConv through the
                                         # hand-written kernels: auto|on|off
                                         # (auto = on for a CUDA device, see
                                         # models/registry.py)

    # bookkeeping (filled by derive())
    pid: int = 0
    N_params: Optional[int] = None

    # ------------------------------------------------------------------ #

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        for k in ("encoder_widths", "decoder_widths", "out_conv"):
            if k in kw:
                kw[k] = _parse_int_list(kw[k])
        return cls(**kw)

    @classmethod
    def load_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def merge_json(self, path: str, no_overwrite: List[str]) -> "Config":
        """Re-load a previous run's conf.json, keeping ``no_overwrite`` fields
        from self (train_reconstruct.py:66-80 semantics)."""
        with open(path) as f:
            loaded = json.load(f)
        known = {f.name for f in dataclasses.fields(type(self))}
        cur = self.to_dict()
        for k, v in loaded.items():
            if k in no_overwrite or k not in known:
                continue
            cur[k] = v
        return Config.from_dict(cur)


def create_parser(mode: str = "train") -> argparse.ArgumentParser:
    """The exact reference flag surface (parse_args.py:5-95) plus the JAX
    package's additions at the bottom."""
    d = Config()  # defaults
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=d.model, type=str)
    p.add_argument("--experiment_name", default=d.experiment_name)

    if mode == "train":
        p.add_argument("--res_dir", default="./results")
        p.add_argument("--plot_every", default=-1, type=int)
        p.add_argument("--export_every", default=-1, type=int)
        p.add_argument("--resume_at", default=0, type=int)
    elif mode == "test":
        p.add_argument("--res_dir", default="./inference", type=str)
        p.add_argument("--plot_every", default=-1, type=int)
        p.add_argument("--export_every", default=1, type=int)
        p.add_argument("--resume_at", default=-1, type=int)

    p.add_argument("--encoder_widths", default="[128]", type=str)
    p.add_argument("--decoder_widths", default="[128,128,128,128,128]", type=str)
    p.add_argument("--out_conv", default=f"[{S2_BANDS}]")
    # NOTE: store_false -- passing the flag disables the feature (parity)
    p.add_argument("--mean_nonLinearity", dest="mean_nonLinearity", action="store_false")
    p.add_argument("--var_nonLinearity", default=d.var_nonLinearity, type=str)
    p.add_argument("--agg_mode", default=d.agg_mode, type=str)
    p.add_argument("--encoder_norm", default=d.encoder_norm, type=str)
    p.add_argument("--decoder_norm", default=d.decoder_norm, type=str)
    p.add_argument("--block_type", default=d.block_type, type=str)
    p.add_argument("--padding_mode", default=d.padding_mode, type=str)
    p.add_argument("--pad_value", default=0, type=float)

    p.add_argument("--n_head", default=d.n_head, type=int)
    p.add_argument("--d_model", default=d.d_model, type=int)
    p.add_argument("--positional_encoding", dest="positional_encoding", action="store_false")
    p.add_argument("--d_k", default=d.d_k, type=int)
    p.add_argument("--low_res_size", default=d.low_res_size, type=int)
    p.add_argument("--use_v", dest="use_v", action="store_true")

    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--rdm_seed", default=d.rdm_seed, type=int)
    p.add_argument("--device", default=d.device, type=str)
    p.add_argument("--display_step", default=d.display_step, type=int)

    p.add_argument("--loss", default=d.loss, type=str)
    p.add_argument("--resume_from", dest="resume_from", action="store_true")
    p.add_argument("--unfreeze_after", default=d.unfreeze_after, type=int)
    p.add_argument("--epochs", default=d.epochs, type=int)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--chunk_size", type=int)
    p.add_argument("--lr", default=d.lr, type=float)
    p.add_argument("--gamma", default=d.gamma, type=float)
    p.add_argument("--val_every", default=d.val_every, type=int)
    p.add_argument("--val_after", default=d.val_after, type=int)

    p.add_argument("--use_sar", dest="use_sar", action="store_true")
    p.add_argument("--pretrain", dest="pretrain", action="store_true")
    p.add_argument("--input_t", default=d.input_t, type=int)
    p.add_argument("--ref_date", default=d.ref_date, type=str)
    p.add_argument("--sample_type", default=d.sample_type, type=str)
    p.add_argument("--vary_samples", dest="vary_samples", action="store_false")
    p.add_argument("--min_cov", default=d.min_cov, type=float)
    p.add_argument("--max_cov", default=d.max_cov, type=float)
    p.add_argument("--root1", default=d.root1, type=str)
    p.add_argument("--root2", default=d.root2, type=str)
    p.add_argument("--root3", default=d.root3, type=str)
    p.add_argument("--precomputed", default=d.precomputed, type=str)
    p.add_argument("--region", default=d.region, type=str)
    p.add_argument("--max_samples_count", default=d.max_samples_count, type=int)
    p.add_argument("--max_samples_frac", default=d.max_samples_frac, type=float)
    p.add_argument("--profile", dest="profile", action="store_true",
                   help="print the eval forward's MFLOP per input sample")
    p.add_argument("--trained_checkp", default="", type=str)

    p.add_argument("--covmode", default=d.covmode, type=str)
    p.add_argument("--scale_by", default=d.scale_by, type=float)
    p.add_argument("--separate_out", dest="separate_out", action="store_true")

    p.add_argument("--weight_folder", type=str, default=d.weight_folder)
    p.add_argument("--use_custom", dest="use_custom", action="store_true")
    p.add_argument("--load_config", default="", type=str)

    # --- flags added by the JAX package ---
    p.add_argument("--mesh_shape", default=None, type=int,
                   help="number of data-parallel ranks, one process per GPU (torchrun "
                        "--nproc_per_node N); the run must have exactly N")
    p.add_argument("--compute_dtype", default=d.compute_dtype, type=str,
                   help="bfloat16|float32 compute dtype for conv/matmul")
    p.add_argument("--cloud_masks", default=d.cloud_masks, type=str,
                   help="cloud mask detector [cloud_cloudshadow_mask|s2cloudless_map|s2cloudless_mask|none]")
    p.add_argument("--synthetic_data", dest="synthetic_data", action="store_true")
    p.add_argument("--synthetic_patch", default=d.synthetic_patch, type=int,
                   help="patch size of the synthetic data source")
    p.add_argument("--remat", dest="remat", action="store_true",
                   help="rematerialize conv blocks to cut activation memory")
    p.add_argument("--no_fast_collate", dest="fast_collate",
                   action="store_false",
                   help="disable the single-pass native batch assembly")
    p.add_argument("--accum_steps", default=d.accum_steps, type=int,
                   help="gradient-accumulation microbatches per step "
                        "(batch_size must be divisible)")
    p.add_argument("--ckpt_backend", default=d.ckpt_backend, type=str,
                   choices=["msgpack", "orbax"],
                   help="checkpoint writer (orbax = async multi-host)")
    p.add_argument("--fused_eval", default=d.fused_eval, type=str,
                   choices=["auto", "on", "off"],
                   help="fused eval MBConv through the hand-written "
                        "kernels (auto = on for a CUDA device)")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true")
    p.add_argument("--trace_dir", default="", type=str,
                   help="write a torch.profiler trace (Chrome trace JSON, one file a "
                        "rank) from the start of the run to the end of its first epoch")
    return p


def parse_config(argv=None, mode: str = "train") -> "Config":
    ns = create_parser(mode).parse_args(argv)
    cfg = Config.from_dict(vars(ns))
    return cfg


def derive(cfg: Config) -> Config:
    """Post-parse derived-config rules (train_reconstruct.py:36-84)."""
    cfg = cfg.replace(
        encoder_widths=_parse_int_list(cfg.encoder_widths),
        decoder_widths=_parse_int_list(cfg.decoder_widths),
        out_conv=_parse_int_list(cfg.out_conv),
    )

    if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by "
                         f"accum_steps {cfg.accum_steps}")

    if cfg.model in ("unet", "utae"):
        assert len(cfg.encoder_widths) == len(cfg.decoder_widths), (
            "unet/utae require matching encoder/decoder depth")
        cfg = cfg.replace(loss="l2")
        if cfg.model == "unet":
            cfg = cfg.replace(pretrain=True, trained_checkp="")

    if cfg.pretrain:  # pre-training is on a single time point
        cfg = cfg.replace(input_t=1, n_head=1, sample_type="pretrain",
                          positional_encoding=False)
        if cfg.model == "unet":
            cfg = cfg.replace(batch_size=32)

    if cfg.loss in ("GNLL", "MGNLL"):
        if cfg.loss == "GNLL":
            cfg = cfg.replace(covmode="uni")
        out_conv = list(cfg.out_conv)
        if cfg.covmode == "iso":
            out_conv[-1] += 1
            cfg = cfg.replace(out_conv=out_conv)
        elif cfg.covmode in ("uni", "diag"):
            out_conv[-1] += S2_BANDS
            cfg = cfg.replace(out_conv=out_conv, var_nonLinearity="softplus")

    cfg = cfg.replace(pid=os.getpid())
    return cfg


def apply_resume(cfg: Config) -> Config:
    """Resume-time merge + lr rescale (train_reconstruct.py:66-84)."""
    if cfg.resume_from:
        load_conf = os.path.join(cfg.res_dir, cfg.experiment_name, "conf.json")
        if cfg.experiment_name != cfg.trained_checkp.split("/")[-2]:
            raise ValueError("Mismatch of loaded config file and checkpoints")
        # the device is where this process runs, not a property of the run:
        # a JAX run's conf.json says "tpu"
        cfg = cfg.merge_json(load_conf, NO_OVERWRITE_RESUME + ["device"])
    if cfg.resume_at >= 0:
        cfg = cfg.replace(lr=cfg.lr * cfg.gamma ** cfg.resume_at)
    return cfg


def input_dim(cfg: Config) -> int:
    """S1_BANDS*use_sar + S2_BANDS (model_utils.py:19)."""
    return 2 * int(cfg.use_sar) + S2_BANDS
