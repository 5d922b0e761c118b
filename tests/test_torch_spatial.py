"""2-D (data x spatial) sharding in the port (``uncrtaints_tpu_torch/parallel``)
and the asynchronous checkpoint of ``ckpt_backend="orbax"`` -- the
counterpart of ``tests/test_spatial_sharding.py``.

The mesh: its shortfall, its data-major coordinates (those of the JAX
package's ``make_mesh_2d``), ``shard_batch`` and its refusals. The plain halo
modes of K5 (forward and adjoint), K2 and K4: bands stitched against the
whole-tensor plain version, K5's against the JAX ``dw_stencil`` on the
halo-concatenated input, their operators through ``opcheck``. One start of
4 gloo ranks as a 2 x 2 mesh at the JAX test's tiny recipe (32x32, B=2,
fp32) against one process: the halo exchange's gradient, the eval step
(also with the attention pooled to 8x8 and upsampled), one train step and
``predict_scene(mesh=)``; and the same eval against the JAX package's own
2 x 4 mesh on the 8 virtual CPU devices, on the same weights. In the same
start: two train steps with and without ``remat``; every other family
``get_generator`` builds (U-Net, U-TAE, UNet3D, the recurrent U-Nets,
ConvLSTM, ConvGRU, FPN) against one process, UNet3D and FPN also against
the JAX 2 x 4 mesh; and the layers that read across bands (strided and
transposed convs, MBConv downsample's pool, the spatial max with ties
across bands) band by band, with their gradients, against the whole scene.
The refusals that remain run in one process on a mesh of two bands.

Tolerances (fp32): the bands sum their statistics, losses and metrics in
another order than one process, so outputs agree to 1e-5 (the eval loss and
metrics relative, pred and var absolute; the families' to 1e-5 of the
largest output), the train loss to 1e-5 relative
and the parameters after one Adam step to 1e-5, except where a gradient is
zero in exact arithmetic (ROADMAP section 3): there both sides hold rounding
noise that Adam turns into a step of up to lr, held to 2 lr. The plain halo
modes stitch to 1e-6 of the largest output (the forward bit-equal; the
adjoint's edge rows and K2's and K4's partial sums add in another order).
A family's train step (train-mode batch statistics of two 32x32 samples)
is held to its tolerance in ``tests/test_torch_baselines.py``,
``test_torch_utae.py`` and ``test_torch_recurrent.py``: the loss and the
train-mode outputs to 1e-4 (RecUNet 2e-3), the gradients to 0.25 of their
norm (U-TAE's bound; the other families read 2e-7 to 1.6e-2). The remat
steps equal the plain ones to 1e-6. Against the JAX 2 x 4 mesh
the JAX test's own tolerances hold (loss rtol 2e-4, pred 2e-3); the measured
gaps are printed.
"""

import os
import sys

import numpy as np
import pytest
import torch

from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.ops import dwconv, dwgrad, mbconv
from uncrtaints_tpu_torch.parallel import (
    Mesh2D, current_mesh_2d, halo_exchange, make_mesh_2d, shard_batch, spatial,
    spatial_sharding, use_mesh_2d)
from uncrtaints_tpu_torch.train import batch_to_device, create_train_state, make_eval_step
from uncrtaints_tpu_torch.train.engine import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_parallel_worker as worker  # noqa: E402
from test_torch_parallel import _run_ranks  # noqa: E402

# the JAX test's tiny recipe (tests/test_spatial_sharding.py:_tiny_cfg), fp32
TINY = dict(use_sar=True, scale_by=10.0, batch_size=2, lr=1e-3, encoder_widths=[32],
            decoder_widths=[32, 32], n_head=4, d_model=64, compute_dtype="float32")
ONE = ((1, 1), (1, 1))


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bands(x, n):
    b = x.shape[1] // n
    return [x[:, i * b:(i + 1) * b].contiguous() for i in range(n)]


def _halos(bands):
    """(top, bot) of each band: its neighbours' edge rows, None at the edge."""
    n = len(bands)
    return [(bands[i - 1][:, -1:].contiguous() if i > 0 else None,
             bands[i + 1][:, :1].contiguous() if i < n - 1 else None) for i in range(n)]


# ------------------------------------------------------------------ mesh --

def test_make_mesh_2d_raises_on_shortfall():
    with pytest.raises(RuntimeError, match="requested 2x2=4"):
        make_mesh_2d(2, 2)


def test_make_mesh_2d_of_one_rank_changes_nothing():
    with use_mesh_2d(None):  # the mesh made here is current until the block ends
        m = make_mesh_2d(1, 1)
        assert current_mesh_2d() is m and m.axis_names == ("data", "spatial")
        assert spatial() is None  # n_spatial == 1: no halo, no collective
    assert current_mesh_2d() is None


def test_mesh_coordinates_are_the_jax_layout():
    """Rank r sits where the JAX package's make_mesh_2d(2, 4) puts device r
    (data-major, mesh_utils.create_device_mesh)."""
    from uncrtaints_tpu.parallel import make_mesh_2d as jax_mesh_2d
    jm = jax_mesh_2d(2, 4)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert jm.axis_names == Mesh2D(0, 2, 4).axis_names
    assert np.array_equal(Mesh2D(0, 2, 4).devices, ids)
    for r in range(8):
        m = Mesh2D(r, 2, 4)
        assert tuple(np.argwhere(ids == r)[0]) == (m.data_rank, m.spatial_rank)


def test_shard_batch_splits_samples_and_rows():
    batch = {"x": np.arange(5 * 3 * 8 * 2).reshape(5, 3, 8, 2, 1), "dates": np.arange(10).reshape(5, 2),
             "y": torch.arange(5 * 8 * 2).reshape(5, 1, 8, 2, 1), "flag": True}
    got = shard_batch(batch, Mesh2D(3, 2, 2))  # data rank 1, band 1
    assert np.array_equal(got["x"], batch["x"][3:, :, 4:])
    assert torch.equal(got["y"], batch["y"][3:, :, 4:])
    assert np.array_equal(got["dates"], batch["dates"][3:]) and got["flag"] is True
    sh = spatial_sharding(Mesh2D(0, 2, 2), 5)
    assert sh.spec == ("data", None, "spatial", None, None)
    with pytest.raises(ValueError, match="even bands"):
        shard_batch({"x": np.zeros((2, 3, 6, 2, 1))}, Mesh2D(0, 1, 4))
    with pytest.raises(ValueError, match="1 samples for 2 data ranks"):
        shard_batch({"x": np.zeros((1, 3, 8, 2, 1))}, Mesh2D(0, 2, 2))


def test_halo_exchange_needs_a_spatial_mesh():
    with pytest.raises(RuntimeError, match="make_mesh_2d"):
        halo_exchange(torch.zeros(1, 4, 4, 2), 1)


# ------------------------------------------------------ plain halo modes --

@pytest.mark.parametrize("n", [2, 4])  # 4 bands of 8 rows: bands of exactly 2 rows
def test_dw_stencil_halo_bands_stitch(rng, n):
    x, w = _t(rng, 2, 8, 7, 4), _t(rng, 4, 1, 3, 3)
    whole = dwconv.dw_stencil(x, w, ONE, "reflect")
    bands = _bands(x, n)
    got = torch.cat([dwconv.dw_stencil(b, w, ONE, "reflect", halo=h)
                     for b, h in zip(bands, _halos(bands))], 1)
    assert float((got - whole).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_dw_adjoint_halo_bands_stitch(rng, n):
    """The bands' input gradients with each halo gradient added to the row
    it came from equal the whole adjoint."""
    g, w = _t(rng, 2, 8, 7, 4), _t(rng, 4, 1, 3, 3)
    whole = dwconv.dw_stencil_reflect_adjoint(g, w)
    parts = [dwconv.dw_stencil_reflect_adjoint(b, w, halo=(i > 0, i < n - 1))
             for i, b in enumerate(_bands(g, n))]
    rows = 8 // n
    got = torch.cat([p[0] for p in parts], 1)
    for i, (_, gtop, gbot) in enumerate(parts):
        assert (gtop is None) == (i == 0) and (gbot is None) == (i == n - 1)
        if gtop is not None:
            got[:, i * rows - 1] += gtop[:, 0]
        if gbot is not None:
            got[:, (i + 1) * rows] += gbot[:, 0]
    assert float((got - whole).abs().max()) <= 1e-6 * float(whole.abs().max())


@pytest.mark.parametrize("n", [2, 4])
def test_dw_kernel_grad_halo_partials_sum(rng, n):
    x, g = _t(rng, 2, 8, 7, 4), _t(rng, 2, 8, 7, 4)
    whole = dwgrad.dw_kernel_grad(x, g, ONE, 3, 3, "reflect")
    scale = dwgrad.dw_kernel_grad(x.abs(), g.abs(), ONE, 3, 3, "reflect")
    bands, gb = _bands(x, n), _bands(g, n)
    got = sum(dwgrad.dw_kernel_grad(b, gg, ONE, 3, 3, "reflect", halo=h)
              for b, gg, h in zip(bands, gb, _halos(bands)))
    assert float(((got - whole).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_norm_gelu_dwconv_halo_bands_stitch(rng, n):
    """K4's outputs stitch; its statistics and pooled sums are the bands'
    partial sums."""
    N, H, W, C = 2, 8, 6, 8
    x = _t(rng, N, H, W, C)
    args = (_t(rng, N, 4), _t(rng, N, 4).abs() + 0.5, _t(rng, C), _t(rng, C), _t(rng, 3, 3, C))
    pa = (_t(rng, C), _t(rng, C))
    whole = mbconv.norm_gelu_dwconv3x3(x, *args, pool_affine=pa)
    bands = _bands(x, n)
    parts = [mbconv.norm_gelu_dwconv3x3(b, *args, pool_affine=pa, halo=h)
             for b, h in zip(bands, _halos(bands))]
    assert float((torch.cat([p[0] for p in parts], 1) - whole[0]).abs().max()) <= 1e-6
    for i in (1, 2, 3):
        tot = sum(p[i] for p in parts)
        assert float(((tot - whole[i]).abs() / whole[i].abs().clamp(min=1.0)).max()) <= 1e-6


def test_dw_stencil_halo_plain_matches_jax_kernel(rng):
    """The halo mode is the JAX stencil (VALID) on the band with its halo
    rows and mirrored columns, the JAX package's own CPU route (interpret)."""
    import jax.numpy as jnp
    from uncrtaints_tpu.ops.pallas_dwconv import dw_stencil
    x, w = _t(rng, 2, 5, 7, 16), _t(rng, 16, 1, 3, 3)
    top, bot = _t(rng, 2, 1, 7, 16), None
    got = dwconv.dw_stencil(x, w, ONE, "reflect", halo=(top, bot))
    xe = dwconv.mirror_cols(dwconv.halo_rows(x, top, bot)).numpy()
    wj = np.transpose(w.numpy(), (2, 3, 1, 0))  # [C,1,3,3] -> [3,3,1,C]
    ref = np.asarray(dw_stencil(jnp.asarray(xe), jnp.asarray(wj), ((0, 0), (0, 0)),
                                interpret=True))
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-6


def test_halo_autograd_reaches_the_neighbours_rows(rng):
    """Two bands of one process whose halo rows are slices of the other
    band: autograd through the halo operator (input gradient by the halo
    adjoint, weight gradient by K2's halo mode) gives the whole conv's."""
    x, w, gy = _t(rng, 2, 8, 7, 4), _t(rng, 4, 1, 3, 3), _t(rng, 2, 8, 7, 4)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (dwconv.dw_stencil(xa, wa, ONE, "reflect") * gy).sum().backward()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    top, bot = xb[:, :4].contiguous(), xb[:, 4:].contiguous()
    y = torch.cat([dwconv.dw_stencil(top, wb, ONE, "reflect",
                                     halo=(None, bot[:, :1].contiguous())),
                   dwconv.dw_stencil(bot, wb, ONE, "reflect",
                                     halo=(top[:, -1:].contiguous(), None))], 1)
    (y * gy).sum().backward()
    assert float((xb.grad - xa.grad).abs().max()) <= 1e-5
    assert float((wb.grad - wa.grad).abs().max()) <= 1e-5 * float(wa.grad.abs().max())


def _opcheck_cases(rng):
    x, w = _t(rng, 2, 4, 7, 4), _t(rng, 4, 1, 3, 3)
    edge = _t(rng, 2, 1, 7, 4)
    C = 8
    x4 = _t(rng, 2, 4, 6, C)
    k4 = [_t(rng, 2, 2), _t(rng, 2, 2).abs(), _t(rng, C), _t(rng, C), _t(rng, 3, 3, C)]
    u = torch.ops.uncrtaints
    return [
        (u.dw_stencil_halo.default, (x, w, edge, None)),
        (u.dw_stencil_halo.default, (x, w, edge, edge.clone())),
        (u.dw_stencil_halo_adjoint.default, (x, w, True, False)),
        (u.dw_kernel_grad_halo.default, (x, _t(rng, 2, 4, 7, 4), None, edge)),
        (u.norm_gelu_dwconv3x3_halo.default, (x4, _t(rng, 2, 1, 6, C), None, *k4, None, None,
                                              2, 4, True)),
        (u.norm_gelu_dwconv3x3_halo.default, (x4, None, _t(rng, 2, 1, 6, C), *k4, _t(rng, C),
                                              _t(rng, C), 2, 1, False)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_opcheck_halo_operators(rng, case):
    op, args = _opcheck_cases(rng)[case]
    torch.library.opcheck(op, args)


def test_opcheck_halo_forward_with_gradients(rng):
    x, w = _t(rng, 2, 4, 7, 4).requires_grad_(), _t(rng, 4, 1, 3, 3).requires_grad_()
    edge = _t(rng, 2, 1, 7, 4).requires_grad_()
    torch.library.opcheck(torch.ops.uncrtaints.dw_stencil_halo.default, (x, w, edge, None))


def test_halo_modes_refuse_what_they_cannot_do(rng):
    x, w = _t(rng, 2, 4, 7, 4), _t(rng, 4, 1, 3, 3)
    with pytest.raises(ValueError, match="reflect mode"):
        dwconv.dw_stencil(x, w, ONE, "zeros", halo=(None, None))
    with pytest.raises(ValueError, match=r"\[N,1,W,C\]"):
        dwconv.dw_stencil(x, w, ONE, "reflect", halo=(_t(rng, 2, 2, 7, 4), None))
    with pytest.raises(ValueError, match="H, W >= 2"):
        dwgrad.dw_kernel_grad(x[:, :1].contiguous(), x[:, :1].contiguous(), ONE, 3, 3,
                              "reflect", halo=(None, None))


# ------------------------------------------------ 2 x 2 gloo ranks, JAX --

def _batch(B=2, H=32):
    """The JAX test's batch (tests/test_spatial_sharding.py:_batch)."""
    rng = np.random.default_rng(0)
    return {"x": rng.random((B, 3, H, H, 15), dtype=np.float32),
            "y": rng.random((B, 1, H, H, 13), dtype=np.float32),
            "dates": rng.integers(0, 1500, (B, 3)).astype(np.float32)}


def _jax_side(batch):
    """The JAX package's tiny recipe at fp32 with non-trivial batch-norm
    statistics: its eval step on one device and on make_mesh_2d(2, 4), and
    the port's state_dict of the same weights."""
    import jax
    import jax.numpy as jnp
    from uncrtaints_tpu.config import Config as JConfig, derive as jderive
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.parallel import make_mesh_2d as jax_mesh_2d
    from uncrtaints_tpu.parallel import replicated_sharding
    from uncrtaints_tpu.parallel import spatial_sharding as jax_spatial_sharding
    from uncrtaints_tpu.train import create_train_state, make_eval_step as jax_eval_step
    from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables
    cfg = jderive(JConfig(**TINY))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = create_train_state(cfg, jax_generator(cfg), jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(1)
    state = state.replace(batch_stats=jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5, jnp.float32),
        state.batch_stats))
    step = jax_eval_step(cfg)
    one = step(state, jb)
    mesh = jax_mesh_2d(2, 4)
    rep, sh = replicated_sharding(mesh), jax_spatial_sharding(mesh, 5)
    sharded = step(jax.device_put(state, rep),
                   {"x": jax.device_put(jb["x"], sh), "y": jax.device_put(jb["y"], sh),
                    "dates": jax.device_put(jb["dates"], rep)})
    sd = from_jax_variables({"params": jax.device_get(state.params),
                             "batch_stats": jax.device_get(state.batch_stats)}, cfg)
    grab = lambda o: {k: np.asarray(o[k]) for k in ("loss", "pred", "var")}
    return grab(one), grab(sharded), sd


def _jax_families():
    """UNet3D (T=4) and FPN of the JAX package (MSE, fp32, random batch
    statistics): {name: (the port's state_dict of their weights, their eval
    forward on one device, on make_mesh_2d(2, 4))} on
    ``worker.family_inputs``."""
    import jax
    import jax.numpy as jnp
    from _torch_pairs import pair
    from uncrtaints_tpu.parallel import make_mesh_2d as jax_mesh_2d
    from uncrtaints_tpu.parallel import replicated_sharding
    from uncrtaints_tpu.parallel import spatial_sharding as jax_spatial_sharding
    mesh = jax_mesh_2d(2, 4)
    out = {}
    for name in ("unet3d", "fpn"):
        model, v, port, tcfg, _ = pair(dict(worker.FAMILIES[name], loss="l2"),
                                       np.random.default_rng(5))
        x = jnp.asarray(worker.family_inputs(tcfg.input_t)[0]["x"])
        fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
        one = fwd(v, x)
        sharded = fwd(jax.device_put(v, replicated_sharding(mesh)),
                      jax.device_put(x, jax_spatial_sharding(mesh, 5)))
        out[name] = (port.state_dict(), np.asarray(one), np.asarray(sharded))
    return out


def _stitch(ranks, key, n_data=2):
    """The bands of ``key`` ([b,1,band,W,C] per rank, data-major) put back
    into the global batch."""
    rows = [torch.cat([ranks[d * 2 + s][key] for s in range(2)], dim=2) for d in range(n_data)]
    return torch.cat(rows, dim=0)


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    """One start of 4 gloo ranks (2 x 2 mesh) on the JAX side's weights, and
    the one-process references of the port."""
    out = tmp_path_factory.mktemp("spatial")
    batch = _batch()
    jax_one, jax_mesh, sd = _jax_side(batch)
    rng = np.random.default_rng(2)
    halo = (_t(rng, 2, 32, 9, 8), _t(rng, 8, 1, 3, 3), _t(rng, 2, 32, 9, 8))
    scene = (rng.random((3, 64, 48, 15)).astype(np.float32),
             rng.integers(0, 1500, 3).astype(np.float32))
    configs = {"tiny": dict(TINY, device="cpu"),
               "pooled": dict(TINY, device="cpu", low_res_size=8)}
    scene_kw = dict(tile=32, overlap=8, batch_size=2)
    jax_families = _jax_families()
    family_weights = {name: v[0] for name, v in jax_families.items()}
    torch.save({"state_dict": sd, "batch": batch, "halo": halo, "configs": configs,
                "scene": scene, "scene_kw": scene_kw, "family_weights": family_weights},
               out / "spatial_inputs.pt")
    ranks = _run_ranks(["spatial"], 4, out)["spatial"]

    ref = {}
    for name, kw in configs.items():
        cfg = derive(Config(**kw))
        model = get_generator(cfg)
        model.load_state_dict(sd)
        ref[f"eval {name}"] = make_eval_step(cfg, with_metrics=True)(
            model, batch_to_device(batch, "cpu"))
        if name == "tiny":
            state, aux = make_train_step(cfg)(create_train_state(cfg, model),
                                              batch_to_device(batch, "cpu"),
                                              torch.Generator().manual_seed(0))
            ref["train"] = {"loss": float(aux["loss"]), "grads": aux["grads"],
                            "state": {k: v.clone() for k, v in model.state_dict().items()}}
            model.load_state_dict(sd)
            from uncrtaints_tpu_torch.infer import predict_scene
            ref["scene"] = predict_scene(model, cfg, *scene, **scene_kw)
    x, w, gy = (t.clone().requires_grad_() for t in halo)
    (dwconv.dw_stencil(x, w, ONE, "reflect") * gy).sum().backward()
    ref["halo"] = (x.grad, w.grad)
    with use_mesh_2d(None):
        ref["families"] = {name: worker.run_family(name, family_weights.get(name))
                           for name in worker.FAMILIES}
        ref["layers"] = {name: worker.run_layer(name) for name in worker.layer_cases()}
        ref["chains"] = {norm: worker.run_chain(norm) for norm in worker.CHAIN_NORMS}
    ref["jax families"] = jax_families
    return ranks, ref, jax_one, jax_mesh


def test_ranks_sit_data_major(spatial_run):
    ranks = spatial_run[0]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_halo_exchange_backward_sums_to_the_whole_conv(spatial_run):
    """Each band's input gradient through K5's halo mode, with its
    neighbours' halo gradients sent back to it, stitches into the whole
    conv's; the bands' weight gradients sum to the whole one's. The data
    ranks repeat the same bands."""
    ranks, ref = spatial_run[:2]
    gx = torch.cat([ranks[s]["halo"][1] for s in range(2)], 1)
    assert float((gx - ref["halo"][0]).abs().max()) <= 1e-5
    gw = ranks[0]["halo"][2] + ranks[1]["halo"][2]
    assert float((gw - ref["halo"][1]).abs().max()) <= 1e-5 * float(ref["halo"][1].abs().max())
    for s in range(2):
        assert torch.equal(ranks[2 + s]["halo"][1], ranks[s]["halo"][1])


@pytest.mark.parametrize("name", ["tiny", "pooled"])
def test_sharded_eval_matches_one_process(spatial_run, name):
    """Loss, pred, var and the per-image metrics of the 2 x 2 mesh against
    one process; the pooled recipe adds the band-wise adaptive max pool and
    the upsample with its one-row halo."""
    ranks, ref = spatial_run[:2]
    key, want = f"eval {name}", ref[f"eval {name}"]
    loss = [float(ranks[d * 2]["eval " + name]["loss"]) for d in range(2)]
    for d in range(2):  # the spatial group agrees on its samples' loss
        assert float(ranks[d * 2 + 1][key]["loss"]) == pytest.approx(loss[d], rel=1e-6)
    # one process's loss is the mean over both samples' pixels
    assert np.mean(loss) == pytest.approx(float(want["loss"]), rel=1e-5)
    for k in ("pred", "var"):
        got = _stitch([r[key] for r in ranks], k)
        assert got.shape == want[k].shape
        assert float((got - want[k]).abs().max()) <= 1e-5, k
    for k, v in want["metrics"].items():
        got = torch.cat([ranks[d * 2][key]["metrics"][k] for d in range(2)])
        other = torch.cat([ranks[d * 2 + 1][key]["metrics"][k] for d in range(2)])
        assert torch.allclose(got, other, rtol=1e-6, atol=0), k
        assert torch.allclose(got, v, rtol=1e-5, atol=1e-7), (k, got, v)


def test_sharded_train_step_matches_one_process(spatial_run):
    ranks, ref = spatial_run[:2]
    want = ref["train"]
    grads = want["grads"]
    gmax = max(float(g.abs().max()) for g in grads.values())
    noise = {n for n, g in grads.items() if float(g.abs().max()) <= 1e-6 * gmax}
    lr = TINY["lr"]
    for r in ranks:
        assert r["train"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for k, v in r["train"]["state"].items():
            assert torch.equal(v, ranks[0]["train"]["state"][k]), k  # replicas stay equal
            tol = 2 * lr if k in noise else 1e-5
            assert float((v - want["state"][k]).abs().max()) <= tol, k


def test_dcp_checkpoint_inside_a_process_group(spatial_run):
    """``ckpt_backend="orbax"`` under 4 gloo ranks: rank 0's asynchronous
    single-process save, every rank's load equal to its own state."""
    assert all(r["dcp"] for r in spatial_run[0])


def test_predict_scene_on_the_mesh_matches_one_process(spatial_run):
    ranks, ref = spatial_run[:2]
    for r in ranks:
        for k in ("pred", "var"):
            assert r["scene"][k].shape == ref["scene"][k].shape == (1, 64, 48, 13)
            assert float(np.abs(r["scene"][k] - ref["scene"][k]).max()) <= 1e-5, k


def test_port_mesh_matches_the_jax_2x4_mesh(spatial_run):
    """The port's 2 x 2 sharded eval against the JAX package's make_mesh_2d(2, 4)
    eval of the same weights and batch, within the JAX test's tolerances."""
    ranks, _, jax_one, jax_mesh = spatial_run
    loss = np.mean([float(ranks[d * 2]["eval tiny"]["loss"]) for d in range(2)])
    gaps = {"loss rel": abs(loss - float(jax_mesh["loss"])) / abs(float(jax_mesh["loss"]))}
    for k in ("pred", "var"):
        got = _stitch([r["eval tiny"] for r in ranks], k).numpy()
        gaps[k] = float(np.abs(got - jax_mesh[k]).max())
        np.testing.assert_allclose(got, jax_mesh[k], rtol=2e-3, atol=2e-3)
    gaps["jax 2x4 vs jax 1 device, pred"] = float(np.abs(jax_mesh["pred"] - jax_one["pred"]).max())
    print(f"port 2x2 mesh vs JAX 2x4 mesh (fp32): {gaps}")
    np.testing.assert_allclose(loss, float(jax_mesh["loss"]), rtol=2e-4, atol=2e-4)


def test_remat_train_steps_on_the_mesh_equal_plain_steps(spatial_run):
    """Two remat train steps on the 2 x 2 mesh (the blocks' recompute runs
    their halo exchanges, group-norm sums and batch-norm all-reduces again
    in the backward, in one order on every rank) against two plain ones:
    losses, gradients, and the parameters and running statistics after."""
    for r in spatial_run[0]:
        (lp, sp, gp), (lr, sr, gr) = r["remat"][False], r["remat"][True]
        assert lr == pytest.approx(lp, rel=1e-6)
        for n, g in gp.items():
            assert float((gr[n] - g).abs().max()) <= 1e-6 * float(g.abs().max()), n
        for k, v in sp[-1].items():
            assert float((sr[-1][k] - v).abs().max()) <= 1e-6 * max(float(v.abs().max()), 1.), k


def _stitch_family(ranks, name, part, key):
    return _stitch([r["families"][name][part] for r in ranks], key)


def _of_max(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# a family's train step: (loss relative and train-mode output RMSE, the
# gradients' gap over their norm)
TRAIN_TOL = {name: (2e-3 if name in ("uconvlstm", "buconvlstm") else 1e-4, 0.25)
             for name in worker.FAMILIES}


@pytest.mark.parametrize("name", list(worker.FAMILIES))
def test_every_family_on_the_mesh_matches_one_process(spatial_run, name):
    """The eval step (loss, pred, metrics), ``predict_scene(mesh=)`` and one
    train step of each family on the 2 x 2 mesh against one process."""
    ranks, ref = spatial_run[:2]
    want = ref["families"][name]
    ev = want["eval"]
    loss = np.mean([float(ranks[d * 2]["families"][name]["eval"]["loss"]) for d in range(2)])
    assert loss == pytest.approx(float(ev["loss"]), rel=1e-5)
    assert _of_max(_stitch_family(ranks, name, "eval", "pred"), ev["pred"]) <= 1e-5
    for k, v in ev["metrics"].items():
        got = torch.cat([ranks[d * 2]["families"][name]["eval"]["metrics"][k] for d in range(2)])
        assert torch.allclose(got, v, rtol=1e-5, atol=1e-7), (k, got, v)
    for r in ranks:
        assert _of_max(r["families"][name]["scene"]["pred"], want["scene"]["pred"]) <= 1e-5

    out_tol, grad_tol = TRAIN_TOL[name]
    tr = want["train"]
    got = _stitch_family(ranks, name, "train", "pred")
    rmse = float((got - tr["pred"]).square().mean().sqrt())
    gaps = []
    for r in ranks:
        t = r["families"][name]["train"]
        assert t["loss"] == pytest.approx(tr["loss"], rel=out_tol)
        num = sum(float((t["grads"][n] - g).square().sum()) for n, g in tr["grads"].items())
        gaps.append((num / sum(float(g.square().sum()) for g in tr["grads"].values())) ** 0.5)
    print(f"{name} on the 2x2 mesh: train pred RMSE {rmse:.3g}, gradient gap {max(gaps):.3g}")
    assert rmse <= out_tol and max(gaps) <= grad_tol


@pytest.mark.parametrize("name", ["unet3d", "fpn"])
def test_families_on_the_mesh_match_the_jax_2x4_mesh(spatial_run, name):
    """UNet3D and FPN on the port's 2 x 2 mesh against the JAX package's
    make_mesh_2d(2, 4) eval forward of the same weights (GSPMD: the
    one-device answer) within 1e-5 of the largest output."""
    ranks, ref = spatial_run[:2]
    _, one, sharded = ref["jax families"][name]
    got = _stitch_family(ranks, name, "eval", "pred")
    gaps = {"port mesh vs JAX mesh": _of_max(got, sharded),
            "JAX mesh vs JAX one device": _of_max(sharded, one)}
    print(f"{name}: {gaps}")
    assert gaps["port mesh vs JAX mesh"] <= 1e-5


@pytest.mark.parametrize("name", list(worker.layer_cases()))
def test_layer_bands_match_the_whole_scene(spatial_run, name):
    """Each layer that reads across bands, run band by band: the outputs
    stitch into the whole scene's, the input gradients (each halo's sent
    back to its owner) too, and the bands' parameter gradients sum to the
    whole one's; the spatial max's gradient splits over its ties in both
    bands as ``amax``'s does."""
    ranks, ref = spatial_run[:2]
    y, gx, gp = ref["layers"][name]
    h = worker.layer_cases()[name][2]
    bands = [ranks[s]["layers"][name] for s in range(2)]
    if name == "max":  # every band holds the scene's max
        assert all(torch.equal(b[0], y) for b in bands)
    else:
        assert float((torch.cat([b[0] for b in bands], h) - y).abs().max()) <= 1e-6 * float(
            y.abs().max())
    assert float((torch.cat([b[1] for b in bands], h) - gx).abs().max()) <= 1e-6 * float(
        gx.abs().max())
    for n, g in gp.items():
        assert float((bands[0][2][n] + bands[1][2][n] - g).abs().max()) <= 1e-5 * float(
            g.abs().max()), n
    for s in range(2):  # the data ranks repeat the bands
        assert torch.equal(ranks[2 + s]["layers"][name][1], bands[s][1])


@pytest.mark.parametrize("norm", list(worker.CHAIN_NORMS))
def test_eval_mbconv_chain_bands_match_the_whole_scene(spatial_run, norm):
    """The eval MBConv's kernel chain band by band (batch norms: K4 in halo
    mode, the pooled sum summed over the spatial group; group norms: the
    group chain, also each norm's statistics summed over it), fp32 through
    the kernels' plain versions: the bands stitch into the whole scene's
    output within 1e-3 of its largest element, RMSE within 2e-5 of it (K3
    rounds its normalised input to bf16, so a statistic summed in another
    order may move an element by one bf16 step, and the pixel's outputs and
    their neighbours' with it: 2.9e-4 and 5.2e-6 of the largest here, on 193
    of 36864 elements; the batch chain, which sums no statistic, stitches
    exactly); the data ranks repeat the bands."""
    ranks, ref = spatial_run[:2]
    want = ref["chains"][norm]
    got = torch.cat([ranks[s]["chains"][norm] for s in range(2)], 1)
    top = float(want.abs().max())
    d = (got - want).abs()
    assert float(d.max()) <= 1e-3 * top and float(d.square().mean().sqrt()) <= 2e-5 * top
    for s in range(2):
        assert torch.equal(ranks[2 + s]["chains"][norm], ranks[s]["chains"][norm])


def _refusal_cases():
    from uncrtaints_tpu_torch.models import blocks, layers, unet, unet3d
    t = lambda *shape: torch.zeros(shape)
    return {
        "odd band of a strided conv": (
            lambda: layers.Conv2d(4, 4, kernel=4, stride=2, pad=1)(t(1, 5, 8, 4)),
            NotImplementedError, "even output bands"),
        "a strided conv of uneven output": (
            lambda: layers.Conv2d(4, 4, kernel=4, stride=2, pad=2)(t(1, 8, 8, 4)),
            NotImplementedError, "even output bands"),
        "a transposed conv not 2x": (
            lambda: unet.ConvTranspose2d(4, 4, kernel=3)(t(1, 4, 8, 4)),
            NotImplementedError, "not 2 x the scene"),
        "UNet3D band not a multiple of 4": (
            lambda: unet3d.UNet3D(15, feats=2)(t(1, 4, 6, 8, 15)),
            NotImplementedError, "multiple of 4"),
        "a band smaller than the halo": (
            lambda: layers.Conv2d(4, 4, pad=4, dilation=4)(t(1, 2, 16, 4)),
            ValueError, "too small for a halo"),
        "MBConv downsample's pool on an odd band": (
            lambda: blocks._max_pool_3x3_s2(t(1, 5, 8, 4)),
            NotImplementedError, "odd"),
        "a circular pad": (
            lambda: layers.Conv2d(4, 4, padding_mode="circular")(t(1, 4, 8, 4)),
            NotImplementedError, "circular"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_the_split_refuses_what_would_cut_a_window(case):
    """What the split still refuses (ROADMAP section 3), each with its
    message, before any collective (one process, a mesh of two bands)."""
    fn, err, msg = _refusal_cases()[case]
    with use_mesh_2d(Mesh2D(0, 1, 2)), pytest.raises(err, match=msg):
        fn()


# ------------------------------------------------- the orbax counterpart --

def _cli_cfg(tmp_path, **kw):
    base = dict(use_sar=True, scale_by=10.0, batch_size=4, lr=1e-3, input_t=3,
                max_samples_count=4, synthetic_data=True, synthetic_patch=16, device="cpu",
                res_dir=str(tmp_path / "results"), experiment_name="run", epochs=1,
                encoder_widths=[16], decoder_widths=[16, 16], n_head=4, d_model=32,
                plot_every=-1, export_every=-1)
    base.update(kw)
    return derive(Config(**base))


def test_dcp_round_trip_async_then_wait(tmp_path):
    """A ``.dcp`` save returns while its write is pending; after
    wait_for_checkpoints the directory holds the state, which loads back
    into a fresh one equal to the bit (model, Adam's moments and count, lr,
    step, epoch)."""
    from uncrtaints_tpu_torch.train import checkpoint as ck
    cfg = _cli_cfg(tmp_path, ckpt_backend="orbax")
    state = create_train_state(cfg, get_generator(cfg))
    with torch.no_grad():
        for t in (*state.opt_state.mu.values(), *state.opt_state.nu.values()):
            t.normal_()
    state.opt_state.count, state.step = 3, 7
    path = ck.save_checkpoint(cfg, 2, state, "model", 0.25)
    assert path.endswith("model.dcp") and ck._PENDING
    ck.wait_for_checkpoints()
    assert not ck._PENDING and os.path.isdir(path)
    assert [p for p in os.listdir(os.path.dirname(path)) if ".tmp" in p or ".prev" in p] == []
    fresh = create_train_state(cfg, get_generator(cfg.replace(rdm_seed=5)))
    fresh, meta = ck.load_checkpoint(cfg, cfg.res_dir, fresh, "model")
    assert meta == {"epoch": 2, "lr": 0.25, "step": 7} and fresh.step == 7
    assert fresh.opt_state.count == 3 and fresh.tx.lr == 0.25
    for a, b in ((state.model.state_dict(), fresh.model.state_dict()),
                 (state.opt_state.mu, fresh.opt_state.mu), (state.opt_state.nu, fresh.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_jax_orbax_directory_is_refused(tmp_path):
    from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint
    cfg = _cli_cfg(tmp_path)
    os.makedirs(os.path.join(cfg.res_dir, "run", "model.orbax"))
    state = create_train_state(cfg, get_generator(cfg))
    with pytest.raises(ValueError, match="JAX package's checkpoint"):
        load_checkpoint(cfg, cfg.res_dir, state, "model")


def test_orbax_runs_resume_and_test_as_pth_tar_runs(tmp_path, monkeypatch):
    """cli.train one epoch, resumed to two, then cli.test: with
    ``--ckpt_backend orbax`` (``.dcp`` directories) every file, parameter
    and test metric equals the ``.pth.tar`` run's to the bit."""
    # the observer's own fallback for a machine without tensorboard (JSONL):
    # its import pulls in tensorflow here, seconds that the check does not need
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import apply_resume
    from uncrtaints_tpu_torch.train.checkpoint import _read
    metrics, blobs = {}, {}
    for backend, suffix in (("orbax", ".dcp"), ("msgpack", ".pth.tar")):
        root = tmp_path / backend
        cli_train.main(_cli_cfg(root, ckpt_backend=backend))
        ckpt = os.path.join(root, "results", "run", "model_epoch_1" + suffix)
        cli_train.main(apply_resume(_cli_cfg(root, ckpt_backend=backend, epochs=2,
                                             resume_from=True, trained_checkp=ckpt,
                                             resume_at=1)))
        exp = root / "results" / "run"
        assert {f"model{suffix}", f"model_epoch_1{suffix}", f"model_epoch_2{suffix}"} <= set(
            os.listdir(exp))
        blobs[backend] = _read(os.path.join(exp, "model_epoch_2" + suffix))[0]
        metrics[backend] = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "run", "--weight_folder", str(root / "results"),
             "--res_dir", str(root / "inference"), "--device", "cpu",
             "--max_samples_count", "4", "--plot_every", "-1", "--export_every", "-1"]))
    a, b = blobs["orbax"], blobs["msgpack"]
    assert {k: a[k] for k in ("epoch", "lr", "step")} == {k: b[k] for k in ("epoch", "lr", "step")}
    assert a["optimizer_G"]["count"] == b["optimizer_G"]["count"] == 2
    for part in ("state_dict_G",):
        assert all(torch.equal(a[part][k], b[part][k]) for k in b[part])
    for m in ("mu", "nu"):
        assert all(torch.equal(a["optimizer_G"][m][k], b["optimizer_G"][m][k])
                   for k in b["optimizer_G"][m])
    assert metrics["orbax"] == metrics["msgpack"]
