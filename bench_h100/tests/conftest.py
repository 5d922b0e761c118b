"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
bench_h100/tests``; the repository's ``pytest tests/`` does not collect them).

``tiny_root`` is a copy of the benchmark's folder beside a BENCHMARK.json of
small cells (the same two families at small widths, 32x32 patches, two
sequences a batch), so a whole run fits on the CPU. ``cuda`` skips a test
where there is no card (decided when the test runs, never at import).
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {
    "tiny_paper": ("uncrtaints_paper_bf16", {
        "port": {"encoder_widths": [32], "decoder_widths": [32, 32], "n_head": 4,
                 "d_model": 32, "low_res_size": 8},
        "model": {"encoder_widths": [32], "decoder_widths": [32, 32], "n_head": 4,
                  "d_model": 32, "low_res_size": 8}}),
    "tiny_utae": ("utae_published_bf16", {
        "port": {"encoder_widths": [16, 16, 16, 32], "decoder_widths": [16, 16, 16, 32],
                 "n_head": 4, "d_model": 32},
        "model": {"encoder_widths": [16, 16, 16, 32], "decoder_widths": [16, 16, 16, 32],
                  "n_head": 4, "d_model": 32}}),
}
TINY_TRAFFIC = {
    "tiny_eval": {"step": "eval", "batch": 2, "patch": 32, "pool": 3,
                  "checked_requests": 2, "reference_block": 1,
                  "trace_seconds": 0.2, "trace_max_requests": 3},
    "tiny_train": {"step": "train", "batch": 2, "patch": 32, "pool": 3, "compared_steps": 3,
                   "warmup_steps": 1, "trace_seconds": 0.2, "trace_max_requests": 2},
}
TINY_CELLS = {"tiny_paper_eval": ("tiny_paper", "tiny_eval"),
              "tiny_paper_train": ("tiny_paper", "tiny_train"),
              "tiny_utae_train": ("tiny_utae", "tiny_train")}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_root(tmp_path: Path) -> Path:
    """A benchmark folder with the tiny cells; returns the folder (its
    BENCHMARK.json is one level up)."""
    root = tmp_path / "bench_h100"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name, (base, change) in TINY_CONFIGS.items():
        cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{base}.json").read_text()))
        cfg["name"] = name
        for key, vals in change.items():
            cfg[key].update(vals)
        write_json(root / "configs" / f"{name}.json", cfg)
        spec["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                "file": f"bench_h100/configs/{name}.json"})
    for name, traffic in TINY_TRAFFIC.items():
        write_json(root / "traffic" / f"{name}.json", traffic)
    for name, (cfg, traffic) in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": cfg, "traffic": traffic, "chips": 1,
                                  "why": "test"})
        real = "paper_eval_b16" if traffic == "tiny_eval" else (
            "paper_train_b16" if cfg == "tiny_paper" else "utae_train_b64")
        limits = BENCH / "limits" / f"{real}.json"
        write_json(root / "limits" / f"{name}.json",
                   json.loads(limits.read_text()) if limits.exists() else {})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "eval" if any("eval" in w for w in m["workloads"]) else "train"
            m["workloads"] = [w for w in TINY_CELLS if kind in w]
    write_json(tmp_path / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
