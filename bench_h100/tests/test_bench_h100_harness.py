"""The harness on the CPU: cells found by name, the result line, the rate and
the tail, and the correctness check refusing the control and every fault.

The tiny cells (conftest.py) carry limits of their own, set from readings at
their size on this CPU (six seeds of the program, three of the control, one
of each fault): the program's largest reading times about 2, the control's
smallest at 3 or more times the program's largest. U-TAE's tiny cell is
left out of the check tests: at 32 pixels of L-TAE its gradients are
ill-conditioned under rounding (test_bench_h100_reference.py), and the
program, the control and the faults read alike.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, write_json
from bench_h100 import faults, harness, systems

CPU = torch.device("cpu")
SEED = 2**31 + 11  # more than 32 signed bits hold
TINY_LIMITS = {
    "tiny_paper_eval": {"pred_rmse": 0.01, "pred_max": 0.03, "loss_gap": 0.004,
                        "var_rmse": 0.014},
    "tiny_paper_train": {"loss_gap": 0.007, "pred_rmse": 0.03, "pred_max": 0.15,
                         "grad_gap": 0.05, "update_gap": 0.12},
}


def tiny_spec(root, name):
    write_json(root / "limits" / f"{name}.json", TINY_LIMITS[name])
    return harness.cell_spec(name, root)


def run(spec, traced=False, seed=SEED, **kw):
    return harness.run_cell(spec, seed, 0.3, traced, CPU, time.perf_counter(), **kw)


@pytest.mark.parametrize("name", ["tiny_paper_eval", "tiny_paper_train"])
def test_sound_run_is_correct_and_line_has_its_keys(tiny_root, name):
    spec = tiny_spec(tiny_root, name)
    for traced in (False, True):
        out = run(spec, traced)
        assert out["correct"] is True and out["failed"] == 0, out["compared"]
        assert out["attempted"] >= 1
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
        assert list(out)[-1] == "compared"
        assert all(set(c) == {"value", "limit"} for c in out["compared"].values())
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
        kind = spec.traffic["step"]
        want = ({f"host_ms.{kind}", f"mfu.{kind}"} if traced
                else {f"{kind}_seq_per_s", "setup_s"})
        assert want <= set(out["metrics"]), out["metrics"]
        for m in out["metrics"].values():
            assert m["value"] > 0 and m["unit"]
        if traced:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert all(len(v) <= 10 for v in out["breakdown"].values())
        json.dumps(out)


@pytest.mark.parametrize("name,fault", [
    ("tiny_paper_eval", "half_batch"), ("tiny_paper_eval", "altered"),
    ("tiny_paper_train", "half_batch"), ("tiny_paper_train", "altered"),
    ("tiny_paper_train", "unchanged"), ("tiny_paper_train", "doubled")])
def test_fault_under_the_timed_path_is_not_correct(tiny_root, name, fault):
    out = run(tiny_spec(tiny_root, name), wrap=faults.FAULTS[fault])
    assert out["correct"] is False and out["failed"] > 0, out["compared"]


@pytest.mark.parametrize("name", ["tiny_paper_eval", "tiny_paper_train"])
def test_control_in_fp8_is_not_correct(tiny_root, name):
    """The reference one precision step below the configuration's bf16
    (float8 e4m3 matrix products) in the program's place, on three seeds."""
    spec = tiny_spec(tiny_root, name)
    if spec.traffic["step"] == "eval":
        factory = lambda cf, b, w, d, s: systems.ReferenceEval(cf, w)
    else:
        factory = lambda cf, b, w, d, s: systems.ReferenceTrain(cf, w)
    for seed in (SEED, SEED + 1, SEED + 2):
        assert run(spec, seed=seed, system_factory=factory)["correct"] is False


def test_new_files_are_picked_up_without_code(tiny_root):
    """A configuration, a traffic mix, a per-layer metric, a kernel's
    accounting and a reference family, each added as a file, and a cell and
    a metric added to BENCHMARK.json: the harness runs them."""
    cfg = json.loads((tiny_root / "configs" / "tiny_paper.json").read_text())
    cfg.update(name="tiny_paper_b3", family="paper_copy")
    write_json(tiny_root / "configs" / "tiny_paper_b3.json", cfg)
    (tiny_root / "reference" / "paper_copy.py").write_text(
        "from bench_h100.reference.uncrtaints import forward  # noqa: F401\n")
    traffic = json.loads((tiny_root / "traffic" / "tiny_eval.json").read_text())
    write_json(tiny_root / "traffic" / "tiny_eval_b3.json", dict(traffic, batch=3))
    (tiny_root / "metrics" / "requests_done.py").write_text(
        "def read(ctx):\n    return float(ctx.window['requests'])\n")
    (tiny_root / "kernels" / "zz_none.py").write_text(
        "OPS = ('uncrtaints::no_such_op',)\nFRAGMENTS = ()\n\n\n"
        "def cost(op, shapes, dtypes, scalars):\n    return 0, 0\n")
    spec_path = tiny_root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny_paper_b3", "source": "test", "reduced": [],
                            "why": "test", "file": "bench_h100/configs/tiny_paper_b3.json"})
    spec["workloads"].append({"name": "tiny_b3", "config": "tiny_paper_b3",
                              "traffic": "tiny_eval_b3", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "bound": 0.25, "source": "host_clock", "workloads": ["tiny_b3"]})
    spec["per_layer"].append({"name": "zz_none_roofline.eval", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "Kernels",
                              "moves": "requests_done", "workloads": ["tiny_b3"]})
    write_json(spec_path, spec)
    write_json(tiny_root / "limits" / "tiny_b3.json", TINY_LIMITS["tiny_paper_eval"])
    cell = harness.cell_spec("tiny_b3", tiny_root)
    assert cell.traffic["batch"] == 3 and cell.config["family"] == "paper_copy"
    out = run(cell)
    assert out["metrics"]["requests_done"]["value"] == out["attempted"]
    assert out["correct"] is True
    traced = run(cell, traced=True)
    assert "zz_none_roofline.eval" not in traced["metrics"]  # nothing to read: left out
    assert "zz_none" in harness.accounting.load_kernels(tiny_root)
    assert systems.family(cell.config).__file__.endswith("paper_copy.py")


class Sleeper:
    """A system whose requests take ``dt`` seconds, one of them ``stall``."""
    kind = "eval"

    def __init__(self, dt, stall_at=None, stall=0.0):
        self.dt, self.stall_at, self.stall, self.n = dt, stall_at, stall, 0

    def __call__(self, batch):
        time.sleep(self.stall if self.n == self.stall_at else self.dt)
        self.n += 1
        return {}


def rate_and_p95(window):
    ctx = harness.SimpleNamespace(window=window, traffic={"batch": 4})
    return (harness.reader("eval_seq_per_s")(ctx), harness.reader("eval_p95_ms")(ctx))


def test_rate_is_all_work_over_all_time_and_a_stall_lowers_it():
    pool = [{}]
    steady = harness.eval_window(Sleeper(0.01), pool, 0.5, CPU)
    stalled = harness.eval_window(Sleeper(0.01, stall_at=5, stall=0.3), pool, 0.5, CPU)
    for w in (steady, stalled):
        rate, _ = rate_and_p95(w)
        assert rate == pytest.approx(4 * w["requests"] / (w["t1"] - w["t0"]))
        assert len(w["latency_s"]) == w["requests"]
    assert rate_and_p95(stalled)[0] < 0.8 * rate_and_p95(steady)[0]


def test_p95_is_over_all_requests():
    lat = [0.001 * (i + 1) for i in range(200)]  # 1 .. 200 ms
    window = {"t0": 0.0, "t1": 1.0, "requests": 200, "latency_s": lat[::-1]}
    assert rate_and_p95(window)[1] == pytest.approx(190.0)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "uncrtaints_tpu_torch_x", sys)
    assert "uncrtaints_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "uncrtaints_tpu.models", sys)
    assert "uncrtaints_tpu" in harness.forbidden_modules()


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "paper_eval_b16",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card_is_correct(cuda):
    """One real cell end to end on the card at its own size, a short window."""
    spec = harness.cell_spec("paper_eval_b16")
    out = harness.run_cell(spec, SEED, 2.0, True, cuda, time.perf_counter())
    assert out["correct"] is True, out["compared"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["mfu.eval"]["value"] <= 100
    assert not math.isnan(out["metrics"]["kernels_roofline.eval"]["value"])
