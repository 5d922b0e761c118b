"""The port's recurrent baselines against the JAX package's, on the CPU:
the recurrent U-Net with a ConvLSTM and with a bidirectional ConvLSTM
bottleneck (``uconvlstm``, ``buconvlstm``), ConvLSTM and ConvGRU with a
conv head (``convlstm``, ``convgru``) and the feature pyramid + ConvLSTM
(``fpn``), all at the widths ``build_recurrent`` gives them.

Each model is initialised in JAX from a seed, with non-trivial batch-norm
statistics where it has batch norms, carried over by ``from_jax_variables``
(``strict=True``); the same numpy batch (B=2, T=3, 32x32, one all-pad frame)
goes through both at fp32, in eval mode (1e-5 RMSE, the golden tests'
bound; measured below 1e-6) and in train mode with the updated running
statistics. Also: the last-valid gather of a padded sequence
(tests/test_baselines.py:116) and the names of the two bidirectional
directions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_pairs import apply, batch, pair, rmse

from uncrtaints_tpu_torch.models.jax_bridge import from_table, jax_to_torch_names

RECURRENT = ("uconvlstm", "buconvlstm", "convlstm", "convgru", "fpn")


@pytest.mark.parametrize("name", RECURRENT)
def test_eval_forward_matches_jax(name):
    model, v, port, tcfg, jcfg = pair(dict(model=name), np.random.default_rng(0))
    b = batch(np.random.default_rng(1), jcfg)
    ref = apply(model, v, b)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(b["x"]), batch_positions=torch.from_numpy(b["dates"]))
    assert got.shape == ref.shape == (2, 1, 32, 32, tcfg.out_conv[-1])
    assert rmse(got, ref) <= 1e-5, rmse(got, ref)


@pytest.mark.parametrize("name", ["uconvlstm", "buconvlstm"])
def test_train_forward_and_batch_statistics_match_jax(name):
    """RecUNet's batch norms (skip, up, out_conv) with batch statistics of
    two samples: the output within 2e-3 RMSE and every updated running
    statistic within 1e-3 relative. Train-mode statistics amplify the fp32
    variance's rounding here: the port alone moves its output by 4.5e-4 RMSE
    when its norms take the variance in two passes instead of as E[x^2] -
    E[x]^2 (the two sides differ by 1.3e-3; in eval mode by below 1e-6)."""
    model, v, port, tcfg, jcfg = pair(dict(model=name), np.random.default_rng(2))
    b = batch(np.random.default_rng(3), jcfg)
    ref, upd = apply(model, v, b, train=True)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(b["x"]), batch_positions=torch.from_numpy(b["dates"]))
    assert rmse(got, ref) <= 2e-3
    stats = from_table({"batch_stats": upd["batch_stats"]},
                       {k: e for k, e in jax_to_torch_names(tcfg).items() if k.startswith("B:")})
    assert stats
    for n, want in stats.items():
        np.testing.assert_allclose(port.state_dict()[n].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=n)


def test_convlstm_pad_mask_selects_last_valid_state():
    """Per-sample last-valid gather: sample 0's last unpadded frame is t=1,
    sample 1's t=3; the port's states equal its own sequence there and the
    JAX layer's on the same weights."""
    from uncrtaints_tpu.models.recurrent import ConvLSTM as JaxConvLSTM
    from uncrtaints_tpu_torch.models.recurrent import ConvLSTM
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32)
    pad = np.array([[False, False, True, True], [False, False, False, False]])
    jm = JaxConvLSTM(hidden_dim=5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), pad_mask=jnp.asarray(pad))
    hs_j, (h_j, c_j) = jm.apply(v, jnp.asarray(x), pad_mask=jnp.asarray(pad))
    port = ConvLSTM(3, 5)
    port.load_state_dict(from_table(v, {
        "cell/gates/kernel": ("cell_list.0.conv.weight", lambda w: np.transpose(w, (3, 2, 0, 1))),
        "cell/gates/bias": ("cell_list.0.conv.bias", lambda w: w)}), strict=True)
    with torch.no_grad():
        hs, (h, c) = port(torch.from_numpy(x), pad_mask=torch.from_numpy(pad))
    assert hs.shape == (2, 4, 8, 8, 5)
    assert torch.equal(h[0], hs[0, 1]) and torch.equal(h[1], hs[1, 3])
    for got, ref in ((hs, hs_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # without a mask: the final states
        hs2, (h2, _) = port(torch.from_numpy(x))
    assert torch.equal(h2, hs2[:, -1])


def test_bidirectional_directions_are_reachable_by_functional_call():
    """The two directions of the bidirectional ConvLSTM are
    ``convlstm_forward`` / ``convlstm_backward``: the train and eval steps
    call the model through torch.func.functional_call, which cannot reach a
    submodule named ``forward`` (torch_import.py's name)."""
    from torch.func import functional_call
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.models import get_generator
    cfg = derive(Config(model="buconvlstm", use_sar=True, device="cpu", loss="l2"))
    model = get_generator(cfg).eval()
    names = [n for n, _ in model.named_parameters() if ".cell_list." in n]
    assert names == [f"temporal_encoder.convlstm_{d}.cell_list.0.conv.{p}"
                     for d in ("forward", "backward") for p in ("weight", "bias")]
    x = torch.rand(1, 3, 16, 16, 15)
    with torch.no_grad():
        out = functional_call(model, dict(model.named_parameters()), (x,))
        assert torch.equal(out, model(x))
