"""The plain reference against the port's CPU path at small widths, and the
reference's imports.

The port runs here in fp32 (the configuration's compute dtype set to
float32 on both sides), so the two may differ only by rounding: eval
outputs and losses within 1e-4, gradients within 1e-3 of each leaf's norm
(of the median leaf's where that is larger). U-TAE's train step is compared
twice: with both of its L-TAE dropouts its losses (the masks must be the
same on both sides), and with the MLP dropout off its gradients, within
1e-2 (its parameters after Adam's steps, which follow the signs of those
gradients, are not compared). In U-TAE's L-TAE, ReLU -> dropout -> a group norm of 8 channels a
pixel makes the gradients upstream of it swing between two fp32 orders of
summation: a near-zero activation that the ReLU passes or not, in a group
whose other channels are zero, is amplified up to 1/sqrt(eps) by the group
norm. Two 32x32 runs (32 L-TAE pixels) differ by tens of % with the dropout
on, by a few 1e-3 with it off.
"""

from __future__ import annotations

import ast
import copy
import json

import pytest
import torch

from conftest import BENCH, TINY_CONFIGS
from bench_h100 import check, systems, weights

FORBIDDEN = {"jax", "jaxlib", "flax", "uncrtaints_tpu"}


def fp32_config(name: str, **model) -> dict:
    base, change = TINY_CONFIGS[name]
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{base}.json").read_text()))
    for key, vals in change.items():
        cfg[key].update(vals)
    cfg["dtype"] = "float32"
    cfg["port"]["compute_dtype"] = "float32"
    cfg["model"].update(model)
    return cfg


def setup(cfg: dict, batch: int = 2, patch: int = 32, seed: int = 2**31 + 5):
    dev = torch.device("cpu")
    shapes = systems.state_shapes(cfg, batch, dev)
    w = weights.seeded_weights(shapes, seed, dev)
    pool = weights.batch_pool(cfg["model"], {"batch": batch, "patch": patch, "pool": 3},
                              seed, dev)
    return dev, w, pool


@pytest.mark.parametrize("name", ["tiny_paper", "tiny_utae"])
def test_reference_matches_port_eval(name):
    cfg = fp32_config(name)
    dev, w, pool = setup(cfg)
    port = systems.PortEval(cfg, 2, w, dev, 0)
    ref = systems.ReferenceEval(cfg, w, q=lambda t: t)
    for batch in pool:
        got, want = port(batch), ref(batch)
        assert set(got) >= set(want)
        for k in want:
            torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,mlp_dropout,grad_tol,update_tol", [
    ("tiny_paper", None, 1e-3, 1e-3), ("tiny_utae", 0.2, None, None),
    ("tiny_utae", 0.0, 1e-2, None)])
def test_reference_matches_port_train(name, mlp_dropout, grad_tol, update_tol):
    model = {} if mlp_dropout is None else {"mlp_dropout": mlp_dropout}
    cfg = fp32_config(name, **model)
    dev, w, pool = setup(cfg)
    port = systems.PortTrain(cfg, 2, w, dev, 0)
    if mlp_dropout == 0.0:
        port.state.model.temporal_encoder.dropout = 0.0
    gen = weights.dropout_generator(7, dev)
    state = gen.get_state()
    got = check.follow(port, pool, gen, 2, cfg["optimizer"]["b1"])
    gen.set_state(state)
    want = check.follow(systems.ReferenceTrain(cfg, w, q=lambda t: t), pool, gen, 2,
                        cfg["optimizer"]["b1"])
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    if mlp_dropout == 0.2:
        return  # ill-conditioned gradients (module docstring): the loss only
    med = sorted(float(g.norm()) for g in want["grad1"].values())[len(want["grad1"]) // 2]
    for n, g in want["grad1"].items():
        err = float((got["grad1"][n] - g).norm())
        assert err <= grad_tol * max(float(g.norm()), med), n
    if update_tol is None:  # Adam's early steps follow the gradients' signs
        return
    moving = [n for n, g in want["grad1"].items() if float(g.norm()) >= check.TINY_GRAD * med]
    change = lambda rec: {n: rec["params"][n] - w[n] for n in moving}
    assert check.leaf_gap(change(got), change(want), moving) <= update_tol


def imported_top_levels(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    """No file of the benchmark imports a module whose top-level name is
    jax, jaxlib, flax or uncrtaints_tpu (compared whole: the port,
    uncrtaints_tpu_torch, is another name); the reference imports nothing of
    the port either."""
    for path in BENCH.rglob("*.py"):
        found = imported_top_levels(path) & FORBIDDEN
        assert not found, (path, found)
    for path in (BENCH / "reference").rglob("*.py"):
        found = imported_top_levels(path) & (FORBIDDEN | {"uncrtaints_tpu_torch"})
        assert not found, (path, found)


def test_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import uncrtaints_tpu_torch.ops\nfrom uncrtaints_tpu.models import x\n")
    assert imported_top_levels(p) & FORBIDDEN == {"uncrtaints_tpu"}
    p.write_text("import uncrtaints_tpu_torch\nimport jaxtyping\n")
    assert not imported_top_levels(p) & FORBIDDEN
