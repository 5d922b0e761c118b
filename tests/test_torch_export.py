"""The port's serving export (``uncrtaints_tpu_torch.export``) on the CPU —
the counterpart of ``tests/test_export.py``.

Tolerances: the artifact runs the live eval step's operators on the same
values (the parameters cast once instead of every call), so it is held to
1e-6 max abs of the live step (it reads 0 here). Against the JAX package's
exported function on the same weights (``from_jax_variables``, fp32 compute):
RMSE <= 1e-5, fp32 sums in another order. ``predict_scene`` through the
artifact against the live one: 1e-6 max abs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.export import export_serving, load_serving, save_serving
from uncrtaints_tpu_torch.infer import predict_scene
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32


def _cfg(**kw):
    return derive(Config(use_sar=True, scale_by=10.0, batch_size=2, lr=1e-3,
                         encoder_widths=[16], decoder_widths=[16, 16], n_head=4, d_model=32,
                         device="cpu", compute_dtype="float32", **kw))


def _inputs(B, seed=0, T=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((B, T, HW, HW, 15), dtype=np.float32))
    dates = torch.from_numpy(rng.integers(0, 1500, (B, T)).astype(np.float32))
    return x, dates


def _live(cfg, model, x, dates):
    return make_eval_step(cfg)(model, {"x": x, "y": torch.zeros(len(x), 1, HW, HW, 13),
                                       "dates": dates})


def _max_abs(a, b):
    return float((a - b).abs().max())


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(cfg, model, path, the loaded artifact): the fp32 recipe exported
    with a symbolic batch."""
    cfg = _cfg()
    model = get_generator(cfg)
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    save_serving(model, cfg, path, height=HW, width=HW)
    return cfg, model, path, load_serving(path)


@pytest.mark.parametrize("B", [1, 2, 3])
def test_round_trip_equals_the_live_eval_step_at_any_batch(artifact, B):
    cfg, model, path, serve = artifact
    x, dates = _inputs(B, seed=B)
    got, ref = serve(x, dates), _live(cfg, model, x, dates)
    assert set(got) == {"pred", "var"} and got["pred"].shape == (B, 1, HW, HW, 13)
    for k in ("pred", "var"):
        assert _max_abs(got[k], ref[k]) <= 1e-6, k


def test_bf16_policy_and_pinned_batch(tmp_path):
    """The default compute dtype (bf16 parameters in the artifact, as the
    eval step casts them) through the fused MBConv operators K3 and K4 at
    widths of 128 (the encoder's group-norm block through the group chain:
    K6's statistics pass, the pooled sum and K6's apply around K3 and K4,
    no pad), with a pinned batch: equal to the live step, and another batch
    size is refused."""
    cfg = derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[128],
                        decoder_widths=[128], n_head=4, d_model=32, device="cpu",
                        fused_eval="on"))
    model = get_generator(cfg)
    ep = export_serving(model, cfg, height=16, width=16, batch=2)
    names = {n.target.name() for n in ep.graph.nodes if n.op == "call_function"
             and isinstance(n.target, torch._ops.OpOverload)
             and n.target.namespace == "uncrtaints"}
    assert names == {"uncrtaints::att_group_aggregate", "uncrtaints::norm_gelu_matmul",
                     "uncrtaints::norm_gelu_dwconv3x3", "uncrtaints::norm_stats",
                     "uncrtaints::norm_gelu_pool", "uncrtaints::norm_apply"}
    assert {p.dtype for k, p in ep.state_dict.items() if "running" not in k} == {torch.bfloat16}
    path = str(tmp_path / "pinned.pt2")
    torch.export.save(ep, path)
    serve = load_serving(path)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, 3, 16, 16, 15), dtype=np.float32))
    dates = torch.from_numpy(np.tile(np.arange(3, dtype=np.float32), (2, 1)))
    got = serve(x, dates)
    ref = make_eval_step(cfg)(model, {"x": x, "y": torch.zeros(2, 1, 16, 16, 13),
                                      "dates": dates})
    for k in ("pred", "var"):
        assert _max_abs(got[k], ref[k]) <= 1e-6, k
    with pytest.raises(Exception, match="(?i)shape|size|expected"):
        serve(torch.cat([x, x[:1]]), torch.cat([dates, dates[:1]]))


def test_artifact_matches_the_jax_packages_exported_function(tmp_path):
    """The JAX package's ``load_serving`` and the port's on one set of
    weights (fp32): RMSE <= 1e-5 on pred and var. Beside it the two
    packages' ``profile_flops`` of that forward: XLA's cost analysis also
    counts the elementwise work (norms, GELU, softmax) that torch's counter
    leaves out, so the JAX figure is 1 to 3 times the port's (2.20 here)."""
    from uncrtaints_tpu.config import Config as JConfig, derive as jderive
    from uncrtaints_tpu.export import load_serving as jload, save_serving as jsave
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables
    jcfg = jderive(JConfig(use_sar=True, scale_by=10.0, batch_size=2, lr=1e-3,
                           encoder_widths=[16], decoder_widths=[16, 16], n_head=4,
                           d_model=32, compute_dtype="float32"))
    x, dates = _inputs(2, seed=7)
    batch = {"x": jnp.asarray(x.numpy()), "y": jnp.zeros((2, 1, HW, HW, 13)),
             "dates": jnp.asarray(dates.numpy())}
    # seeded weights on the variables' shapes (jax.eval_shape: flax's own
    # init takes 18 s here), fan-in scaled; batch statistics around (0, 1)
    jm = jax_generator(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch["x"],
                                            batch_positions=batch["dates"], train=False))
    rng = np.random.default_rng(0)
    fan = lambda a: np.prod(a.shape[:-1]) if len(a.shape) > 1 else 100.0
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) / np.sqrt(fan(a)), jnp.float32), shapes["params"])
    stats = jax.tree.map(lambda a: jnp.asarray(
        np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5, jnp.float32), shapes["batch_stats"])

    class State:  # what the JAX package's export reads of a train state
        pass
    state = State()
    state.params, state.batch_stats, state.apply_fn = params, stats, jm.apply
    jpath = str(tmp_path / "model.uxp")
    jsave(state, jcfg, jpath, height=HW, width=HW, platforms=("cpu",))
    ref = jload(jpath)(batch["x"], batch["dates"])

    cfg = _cfg()
    model = get_generator(cfg)
    model.load_state_dict(from_jax_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, cfg), strict=True)
    path = str(tmp_path / "model.pt2")
    save_serving(model, cfg, path, height=HW, width=HW)
    got = load_serving(path)(x, dates)
    for k in ("pred", "var"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-5, k

    from uncrtaints_tpu.train.engine import profile_flops as jflops
    from uncrtaints_tpu_torch.train.engine import profile_flops
    ratio = jflops(jcfg, state, batch) / profile_flops(
        cfg, model, {"x": x, "y": torch.zeros(2, 1, HW, HW, 13), "dates": dates})
    assert 1.0 <= ratio <= 3.0, ratio


def test_predict_scene_through_the_artifact(artifact):
    cfg, model, path, serve = artifact
    rng = np.random.default_rng(3)
    scene = rng.random((3, 48, 40, 15), dtype=np.float32)
    dates = rng.integers(0, 1500, (3,)).astype(np.float32)
    live = predict_scene(model, cfg, scene, dates, tile=HW, overlap=8, batch_size=2)
    got = predict_scene(None, None, scene, dates, tile=HW, overlap=8, batch_size=2,
                        device="cpu", forward_fn=serve)
    for k in ("pred", "var"):
        assert float(np.abs(got[k] - live[k]).max()) <= 1e-6, k


def test_a_fresh_interpreter_serves_with_the_export_module_alone(artifact):
    """Only ``uncrtaints_tpu_torch.export`` is imported (it registers the
    operators); no model code is loaded, and the outputs equal the live
    step's."""
    cfg, model, path, _ = artifact
    x, dates = _inputs(2, seed=11)
    ref = _live(cfg, model, x, dates)
    io = os.path.join(os.path.dirname(path), "io.pt")
    torch.save({"x": x, "dates": dates}, io)
    code = (
        "import sys, torch\n"
        "from uncrtaints_tpu_torch.export import load_serving\n"
        f"d = torch.load({io!r})\n"
        f"out = load_serving({path!r})(d['x'], d['dates'])\n"
        f"torch.save({{k: v for k, v in out.items()}}, {io!r})\n"
        "bad = [m for m in sys.modules if m.startswith(('uncrtaints_tpu_torch.models',\n"
        "       'uncrtaints_tpu_torch.train', 'jax', 'uncrtaints_tpu.'))]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(io)
    for k in ("pred", "var"):
        assert _max_abs(got[k], ref[k]) <= 1e-6, k
