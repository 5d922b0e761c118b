"""The port's U-Net, U-TAE (with and without ``pretrain``) and UNet3D
against the JAX package's, on the CPU; the bridge tables of every baseline
against uncrtaints_tpu/models/torch_import.py; the MBConv variants no
configured model builds; UNet3D's refusal of T < 4.

Each model is initialised in JAX from a seed at small widths (encoder and
decoder [8,8,8,16], n_head 4, d_model 16, 32x32, T=3 with one all-pad frame;
UNet3D at its fixed width and T=4), with non-trivial batch-norm statistics,
carried over by ``from_jax_variables`` (``strict=True``), and the same numpy
batch goes through both at fp32. Bound: the golden tests' 1e-5 RMSE
(tests/test_baseline_golden.py); the eval forwards agree to below 1e-6.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from _torch_pairs import MODELS, apply, batch, configs, pair, port_without_dropout, rmse

from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import from_table, jax_to_torch_names, mbconv_names


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_forward_matches_jax(name):
    rng = np.random.default_rng(0)
    model, v, port, tcfg, jcfg = pair(MODELS[name], rng)
    b = batch(np.random.default_rng(1), jcfg)
    ref = apply(model, v, b)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(b["x"]), batch_positions=torch.from_numpy(b["dates"]))
    assert got.shape == ref.shape == (2, 1, 32, 32, tcfg.out_conv[-1])
    assert rmse(got, ref) <= 1e-5, rmse(got, ref)


@pytest.mark.parametrize("name", ["unet", "utae", "unet3d"])
def test_train_forward_and_batch_statistics_match_jax(name):
    """One train-mode forward (batch statistics, the running statistics
    updated) on both sides, dropout off: outputs and every updated running
    mean and variance agree. The outputs to 1e-4 RMSE, not eval's 1e-5: the
    norms' fp32 variance E[x^2] - E[x]^2 rounds differently on the two sides
    (another summation order; U-TAE's first group norm differs by 7.5e-6 RMSE
    in either mode), and normalising by the statistics of a batch of two
    small maps amplifies it (U-TAE: 2e-5)."""
    rng = np.random.default_rng(2)
    model, v, port, tcfg, jcfg = pair(MODELS[name], rng)
    b = batch(np.random.default_rng(3), jcfg)
    ref, upd = apply(model, v, b, train=True)
    port = port_without_dropout(port).train()
    with torch.no_grad():
        got = port(torch.from_numpy(b["x"]), batch_positions=torch.from_numpy(b["dates"]))
    assert rmse(got, ref) <= 1e-4
    stats = from_table({"batch_stats": upd["batch_stats"]},
                       {k: e for k, e in jax_to_torch_names(tcfg).items() if k.startswith("B:")})
    assert stats
    sd = port.state_dict()
    for n, want in stats.items():  # UNet3D's 3-D convolutions: 4e-5 relative
        np.testing.assert_allclose(sd[n].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_unet3d_refuses_fewer_than_four_frames():
    """At T=3 the second temporal max pool has no output frame: the JAX model
    still answers (flax's pool returns the empty axis and the transposed
    conv pads it up again); the port raises and names the cause."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    jcfg, tcfg = configs(model="unet3d", input_t=3)
    b = batch(np.random.default_rng(8), jcfg, H=16)
    model = jax_generator(jcfg)
    x = jnp.asarray(b["x"])
    out = model.apply(model.init(jax.random.PRNGKey(0), x), x)
    assert out.shape == (2, 1, 16, 16, 26)
    port = get_generator(tcfg, "cpu").eval()
    with pytest.raises(ValueError, match="T >= 4"):
        port(torch.from_numpy(b["x"]))


# the bridge tables against torch_import's, key for key
def _forward_table(name, jcfg):
    from uncrtaints_tpu.models import torch_import as ti
    if name in ("unet", "utae_pretrain"):
        return ti.unet_mapping(jcfg)
    if name.startswith("utae"):
        return ti.utae_mapping(jcfg)
    if name == "unet3d":
        return ti.unet3d_mapping()
    if name in ("uconvlstm", "buconvlstm"):
        table = ti.recunet_mapping(4, "lstm" if name == "uconvlstm" else "blstm")
        # the port's names of the two directions (models/recurrent.py)
        return {k: (v[0].replace(".forward.", ".convlstm_forward.")
                    .replace(".backward.", ".convlstm_backward."), v[1])
                for k, v in table.items()}
    return ti.fpn_mapping(5)


@pytest.mark.parametrize("name", ["unet", "utae", "utae_pretrain", "unet3d", "uconvlstm",
                                  "buconvlstm", "fpn"])
def test_bridge_table_inverts_torch_import(name):
    """Every flax path maps to the same torch name in both tables, the
    port's transform undoes torch_import's on an array of the flax leaf's
    shape, and the names are the port model's state_dict keys."""
    kw = MODELS.get(name, dict(model=name))
    jcfg, tcfg = configs(**kw)
    ours, theirs = jax_to_torch_names(tcfg), _forward_table(name, jcfg)
    assert {k: v[0] for k, v in ours.items()} == {k: v[0] for k, v in theirs.items()}
    rng = np.random.default_rng(9)
    sd = get_generator(tcfg, "cpu").state_dict()
    assert set(sd) == {v[0] for v in ours.values()}
    for fp, (tname, tf) in ours.items():
        t = rng.standard_normal(sd[tname].shape).astype(np.float32)
        np.testing.assert_array_equal(tf(theirs[fp][1](t)), t, err_msg=fp)


MBCONV_CASES = [(1, False, "batch"), (1, True, "group"), (4, True, "batch"),
                (4, True, "group")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("expansion, downsample, norm", MBCONV_CASES)
def test_mbconv_variants_match_jax(expansion, downsample, norm, train):
    """MBConv with expansion 1 (no first pointwise conv, no SE) and with
    downsample (stride-2 body, max pool + 1x1 projection) against the JAX
    block at fp32, eval and train mode (running statistics updated)."""
    from uncrtaints_tpu.models.blocks import MBConv as JaxMBConv
    from uncrtaints_tpu_torch.models.blocks import MBConv
    inp, oup = 8, 16 if downsample else 8
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 12, 10, inp)).astype(np.float32)
    jm = JaxMBConv(inp, oup, downsample=downsample, expansion=expansion, norm=norm)
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5, jnp.float32),
            v["batch_stats"])
    table = mbconv_names(norm, expansion, downsample)
    port = MBConv(inp, oup, expansion=expansion, norm=norm, downsample=downsample)
    port.load_state_dict(from_table(v, table), strict=True)
    port.train(train)
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref, upd = jm.apply(v, jnp.asarray(x)), {}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    shape = (3, 6, 5, oup) if downsample else (3, 12, 10, oup)
    assert got.shape == ref.shape == shape
    assert rmse(got, ref) <= 1e-5
    if upd:
        stats = from_table({"batch_stats": upd["batch_stats"]},
                           {k: e for k, e in table.items() if k.startswith("B:")})
        for n, want in stats.items():
            np.testing.assert_allclose(port.state_dict()[n].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=n)


def test_mbconv_fused_eval_keeps_to_the_standard_block():
    """The fused eval chain serves only the standard block (no downsample,
    expansion above 1), as in the JAX package: the variants run their plain
    body even with fused_eval on. Of the norms, batch takes the batch chain
    and group norm at 128 channels (groups of whole 8-channel chunks) the
    group chain, in eval only, also under a spatial split (a band each);
    instance norm, ``none``, train mode and groups of 4 channels keep the
    standard body."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.parallel.mesh import Mesh2D, use_mesh_2d
    x = torch.randn(1, 8, 8, 128)

    def route(blk, train=False):
        called = []
        for body in ("_body", "_fused_body", "_fused_group_body"):
            setattr(blk, body, lambda a, body=body: called.append(body) or a)
        blk.train(train)
        with torch.no_grad():
            blk(x)
        return called

    for kw in (dict(expansion=1), dict(expansion=2, downsample=True)):
        for norm in ("batch", "group"):
            assert route(MBConv(128, 128, fused_eval=True, norm=norm, **kw)) == ["_body"], kw
    assert route(MBConv(128, 128, expansion=2, norm="batch", fused_eval=True)) == ["_fused_body"]
    assert route(MBConv(128, 128, expansion=2, norm="group", fused_eval=True)) == [
        "_fused_group_body"]
    for norm in ("instance", "none"):
        assert route(MBConv(128, 128, expansion=2, norm=norm, fused_eval=True)) == ["_body"]
    for norm in ("batch", "group"):
        assert route(MBConv(128, 128, expansion=2, norm=norm, fused_eval=True),
                     train=True) == ["_body"]
        assert route(MBConv(128, 128, expansion=2, norm=norm)) == ["_body"]  # fused_eval off
    assert route(MBConv(128, 128, expansion=2, norm="group", n_groups=32,
                        fused_eval=True)) == ["_body"]
    with use_mesh_2d(Mesh2D(0, 1, 2)):
        assert route(MBConv(128, 128, expansion=2, norm="group", fused_eval=True)) == [
            "_fused_group_body"]
        assert route(MBConv(128, 128, expansion=2, norm="batch", fused_eval=True)) == [
            "_fused_body"]
    with pytest.raises(ValueError, match="inp == oup"):
        MBConv(8, 16)
