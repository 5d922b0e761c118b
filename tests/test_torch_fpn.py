"""FPN-ConvLSTM at its published widths (``bench_h100/configs/fpn_convlstm_bf16.json``)
on the CPU: the port, built and driven through the benchmark's entry points
(``systems.PortEval`` / ``PortTrain``), against the plain reference
``bench_h100/reference/fpn.py``; the reference's FLOP count and imports; the
port's spans and counters in a traced train step.

The port runs in fp32 here (the configuration's compute dtype set to float32
on both sides), so the two differ only by the order of fp32 sums: eval
outputs and losses within 1e-4, the first gradients within 1e-3 of each
leaf's norm (of the median leaf's where that is larger). Patches are 16x16:
the pyramid's widest reflect pad is 8, which needs more than 8 pixels.
"""

import ast
import copy
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uncrtaints_tpu_torch import tracing
from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.models.registry import get_generator
from uncrtaints_tpu_torch.train.engine import create_train_state, make_train_step

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench_h100 import accounting, check, systems, weights  # noqa: E402
from bench_h100.reference import common  # noqa: E402

CONFIG = json.loads((REPO / "bench_h100" / "configs" / "fpn_convlstm_bf16.json").read_text())
B, T, S = 2, 3, 16
SEED = 2**31 + 5


def fp32_config() -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg["dtype"] = cfg["port"]["compute_dtype"] = "float32"
    return cfg


def pool_of(cfg: dict, padded: bool):
    """Two batches; with ``padded`` the second sample's last frame of the
    second batch is all ``pad_value``, so its last cell state is frame 1's."""
    dev = torch.device("cpu")
    pool = weights.batch_pool(cfg["model"], {"batch": B, "patch": S, "pool": 2}, SEED, dev)
    if padded:
        pool[1]["x"][1, T - 1] = cfg["model"]["pad_value"]
    return pool


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", ["eval", "train"])
def test_port_matches_reference(kind, padded):
    cfg = fp32_config()
    dev = torch.device("cpu")
    w = weights.seeded_weights(systems.state_shapes(cfg, B, dev), SEED, dev)
    pool = pool_of(cfg, padded)
    if kind == "eval":
        port = systems.PortEval(cfg, B, w, dev, 0)
        ref = systems.ReferenceEval(cfg, w, common.exact)
        for batch in pool:
            got, want = port(batch), ref(batch)
            for k in want:
                torch.testing.assert_close(got[k].float(), want[k], rtol=1e-4, atol=1e-4)
        return
    gen = weights.dropout_generator(SEED, dev)
    state = gen.get_state()
    got = check.follow(systems.PortTrain(cfg, B, w, dev, 0), pool, gen, 2, 0.9)
    gen.set_state(state)
    want = check.follow(systems.ReferenceTrain(cfg, w, common.exact), pool, gen, 2, 0.9)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    med = sorted(float(g.norm()) for g in want["grad1"].values())[len(want["grad1"]) // 2]
    for n, g in want["grad1"].items():
        assert float((got["grad1"][n] - g).norm()) <= 1e-3 * max(float(g.norm()), med), n


def conv_flops(b: int, s: int) -> dict:
    """Multiply-adds x 2 of each convolution of the forward at the published
    widths, by hand: {name: FLOPs}."""
    m = CONFIG["model"]
    px, frames = s * s, b * m["input_t"]
    c0, c1 = m["inconv"]
    n, lv, hid = m["n_channels"], m["n_levels"], m["hidden_size"]
    mid = n * lv // 2
    per = lambda cin, cout, k=9: 2 * px * cin * cout * k
    return {"inconv.0": frames * per(m["input_dim"], c0), "inconv.3": frames * per(c0, c1),
            "pyramid": frames * lv * per(c1, n), "mid_conv": frames * per(n * lv, mid),
            "convlstm": frames * per(mid + hid, 4 * hid),
            "outconv": b * per(hid, m["out_channels"], 1)}


@pytest.mark.parametrize("step", ["eval", "train"])
def test_reference_flops_equal_the_hand_count(step):
    """The FLOPs ``mfu`` counts (the reference on the meta device): the
    forward's convolutions, and for a train step twice more for their input
    and weight gradients, less the first conv's input gradient (the input
    needs none)."""
    shapes = systems.state_shapes(CONFIG, B, torch.device("meta"))
    got = accounting.request_flops(CONFIG, {"step": step, "batch": B, "patch": S}, shapes)
    fwd = conv_flops(B, S)
    want = sum(fwd.values())
    if step == "train":
        want = 3 * want - fwd["inconv.0"]
    assert got == want


def test_reference_imports_nothing_of_jax_or_the_packages():
    """The reference imports torch and the benchmark's common layers alone:
    nothing of JAX, of the JAX package or of the port, and no kernel."""
    tree = ast.parse((REPO / "bench_h100" / "reference" / "fpn.py").read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            modules.add("__import__")
    assert modules == {"__future__", "torch", "torch.nn.functional", "bench_h100.reference"}


def test_train_step_spans_and_counters():
    """One traced train step at the configuration's bf16: the sections
    ``encoder``, ``convlstm``, ``decoder`` in order; the ``convlstm`` counter
    is [x, h] (248 channels) and the gates (352) each time step, the
    ``reflect_pad`` counter the padded maps of the reflect convs (inconv's
    two at pad 1, the pyramid's at pads 1, 2, 4, 8, mid_conv's at pad 1), all
    in bf16."""
    tracing.take()
    cfg = derive(Config(**CONFIG["port"], batch_size=B, device="cpu"))
    torch.manual_seed(0)
    state = create_train_state(cfg, get_generator(cfg, device=torch.device("cpu")))
    batch = pool_of(CONFIG, False)[0]
    with profile(activities=[ProfilerActivity.CPU]):
        make_train_step(cfg)(state, batch, torch.Generator().manual_seed(2))
    (rec,) = tracing.take()
    names = [sp.name for sp in rec.spans]
    assert [n for n in names if n in ("encoder", "convlstm", "decoder")] == [
        "encoder", "convlstm", "decoder"]
    assert names.index("decoder") < names.index("backward")
    frames, bf16 = B * T, 2
    assert rec.counters["convlstm"] == T * B * S * S * (248 + 352) * bf16
    padded = (S + 2) ** 2 * (15 + 32 + 64 + 320) + sum((S + 2 * d) ** 2 * 64 for d in (2, 4, 8))
    assert rec.counters["reflect_pad"] == frames * padded * bf16
