"""U-TAE's training path and its kernel path in the port against the JAX
package's, on the CPU: one train step against jax.value_and_grad, the
eval-mode gradients parameter by parameter, the three skip-level
aggregations a forward (K1's path on the card), and the U-Net -> U-TAE
transfer of ``--trained_checkp`` against ``import_params_partial``.
Models and batches as in tests/test_torch_baselines.py (tests/_torch_pairs.py).
"""

import os

import numpy as np
import torch

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp

from _torch_pairs import MODELS, _no_dropout, batch, configs, pair, port_without_dropout

from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import jax_to_torch_names


def _jax_loss(model, v, jcfg, b, train):
    """loss(params) of the JAX model on batch b (both dropouts off)."""
    from uncrtaints_tpu.losses import calc_loss, get_loss
    from uncrtaints_tpu.train.engine import _prepare_xy, _split_out
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    x, y, _ = _prepare_xy(jcfg, jb)
    crit = get_loss(jcfg)

    def loss_fn(params):
        with fnn.intercept_methods(_no_dropout):
            out = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                              batch_positions=jb["dates"], train=train, mutable=["batch_stats"])[0]
        mean, var = _split_out(out.astype(jnp.float32), jcfg)
        return calc_loss(crit, jcfg, mean, y, var=var)[0]

    return loss_fn


def _torch_grads(g, tcfg):
    table = jax_to_torch_names(tcfg)
    return {table[k][0]: table[k][1](np.asarray(a)) for k, a in
            flax.traverse_util.flatten_dict(flax.core.unfreeze(g), sep="/").items()}


def test_utae_train_step_matches_jax():
    """One U-TAE train step (MSE, batch statistics, both dropouts off) of the
    port against jax.value_and_grad: the loss within 1e-4 relative; the
    gradients as a whole within 0.25 (the L2 norm of the difference over
    that of the JAX gradient). At these widths the train-mode step is
    ill-conditioned: the port alone moves its gradients by 0.116 of that norm
    when its norms take the variance in two passes instead of as E[x^2] -
    E[x]^2, and the two sides differ by 0.12 (0.15 on a batch without a pad
    frame); per parameter the eval-mode test below holds them tightly."""
    from uncrtaints_tpu_torch.train import batch_to_device, create_train_state, make_train_step
    rng = np.random.default_rng(4)
    model, v, port, tcfg, jcfg = pair(MODELS["utae"], rng)
    assert jcfg.loss == tcfg.loss == "l2"
    b = batch(np.random.default_rng(5), jcfg)
    loss, g = jax.jit(jax.value_and_grad(_jax_loss(model, v, jcfg, b, train=True)))(v["params"])
    ref = _torch_grads(g, tcfg)
    state = create_train_state(tcfg, port_without_dropout(port))
    _, aux = make_train_step(tcfg)(state, batch_to_device(b, "cpu"))
    assert "var" not in aux and aux["pred"].shape == (2, 1, 32, 32, 13)
    assert abs(float(aux["loss"]) / float(loss) - 1) <= 1e-4
    assert set(aux["grads"]) == set(ref)
    diff = sum(((aux["grads"][n].numpy() - a) ** 2).sum() for n, a in ref.items())
    assert (diff / sum((a ** 2).sum() for a in ref.values())) ** 0.5 <= 0.25


def test_utae_gradients_match_jax_in_eval_mode():
    """jax.grad of the U-TAE's MSE with the running statistics (eval mode)
    against the port's autograd (the aggregator's backward, the upsampled
    attention, the transposed convs): every parameter within 2e-3 of its
    gradient's largest element (measured: 6e-4 at most), plus 1e-4 of the
    largest gradient of all (a group norm's input bias keeps only what is
    left of its gradient after the group's mean is removed)."""
    rng = np.random.default_rng(4)
    model, v, port, tcfg, jcfg = pair(MODELS["utae"], rng)
    b = batch(np.random.default_rng(5), jcfg)
    ref = _torch_grads(jax.jit(jax.grad(_jax_loss(model, v, jcfg, b, train=False)))(v["params"]),
                       tcfg)
    port = port.eval()
    x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
    (port(x, batch_positions=torch.from_numpy(b["dates"])) - y).square().mean().backward()
    gmax = max(np.abs(a).max() for a in ref.values())
    for n, p in port.named_parameters():
        top = np.abs(ref[n]).max()
        if top <= 1e-6 * gmax:  # zero in exact arithmetic: rounding noise on both sides
            assert float(p.grad.abs().max()) <= 1e-5 * gmax, n
        else:
            assert np.abs(p.grad.numpy() - ref[n]).max() <= 2e-3 * top + 1e-4 * gmax, n


def test_utae_launches_one_aggregation_per_skip_level(monkeypatch):
    """Three skip levels: three att_group aggregations a forward, each with
    16-head attention upsampled to its level (the path K1 runs on the card)."""
    from uncrtaints_tpu_torch.models import aggregator
    _, tcfg = configs(model="utae", encoder_widths=[32, 32, 32, 64],
                      decoder_widths=[16, 16, 32, 64], d_model=16)
    assert tcfg.n_head == 16
    seen = []
    real = aggregator.att_group_aggregate
    monkeypatch.setattr(aggregator, "att_group_aggregate",
                        lambda x, a: seen.append((tuple(x.shape), a.shape[-1])) or real(x, a))
    port = get_generator(tcfg, "cpu").eval()
    b = batch(np.random.default_rng(6), tcfg)
    with torch.no_grad():
        port(torch.from_numpy(b["x"]), batch_positions=torch.from_numpy(b["dates"]))
    assert seen == [((2, 3, 8, 8, 32), 16), ((2, 3, 16, 16, 32), 16), ((2, 3, 32, 32, 32), 16)]


def test_unet_to_utae_transfer_copies_what_import_params_partial_copies(tmp_path):
    """--trained_checkp from a U-Net .pth.tar into a U-TAE: the port copies
    the parameters the JAX package's import_params_partial transfers, with
    the same values, and freezes them all but the output head."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.models.torch_import import import_params_partial
    from uncrtaints_tpu_torch.train import create_train_state
    from uncrtaints_tpu_torch.train.checkpoint import load_pretrained_partial
    _, unet_cfg = configs(**MODELS["unet"])
    # every tensor moved off its init (group norms start at ones and zeros)
    src = {k: t + torch.rand(t.shape) for k, t in
           get_generator(unet_cfg.replace(rdm_seed=11), "cpu").state_dict().items()}
    path = os.path.join(str(tmp_path), "unet.pth.tar")
    torch.save({"epoch": 1, "state_dict_G": src}, path)

    jcfg, tcfg = configs(**MODELS["utae"])
    b = batch(np.random.default_rng(7), jcfg)
    model = jax_generator(jcfg)
    params = jax.jit(lambda k, x, d: model.init(k, x, batch_positions=d)["params"])(
        jax.random.PRNGKey(0), jnp.asarray(b["x"]), jnp.asarray(b["dates"]))
    new, transferred = import_params_partial(jcfg, params, {k: t.numpy() for k, t in src.items()})
    table = jax_to_torch_names(tcfg)
    path_of = lambda ks: "/".join(p.strip("'") for p in ks.strip("[]").split("]["))
    want = {table[path_of(ks)][0] for ks in transferred}
    assert want and all(n in src for n in want)

    state = create_train_state(tcfg, get_generator(tcfg, "cpu"))
    init = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, mask = load_pretrained_partial(tcfg, state, path)
    got = {n for n, p in state.model.named_parameters()
           if not torch.equal(p, init[n]) and torch.equal(p, src[n])}
    assert got == want
    flat_new = {path_of(jax.tree_util.keystr(k)): np.asarray(a)
                for k, a in jax.tree_util.tree_flatten_with_path(new)[0]}
    sd = state.model.state_dict()
    for fp, (tname, tf) in table.items():
        if tname in want:
            np.testing.assert_array_equal(sd[tname].numpy(), tf(flat_new[fp]), err_msg=tname)
    assert {n for n, m in mask.items() if m == 0.0} == {n for n in want if "out_conv" not in n}
    assert any("out_conv" in n for n in want)
