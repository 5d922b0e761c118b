"""Every model family ``get_generator`` builds, from the JAX package's
``.ckpt`` into the port, on the CPU: JAX init -> the JAX ``save_checkpoint``
-> the port's ``load_checkpoint`` gives the JAX variables mapped, bit for
bit, and the JAX eval forward's output (a file of its own beside
tests/test_torch_jax_checkpoint.py: the JAX compiles of ten families take a
worker's minute and a half).
"""

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import jax_to_torch_names
from uncrtaints_tpu_torch.train import create_train_state
from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint

from _torch_pairs import MODELS, apply, batch as pair_batch, pair, rmse


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree), sep="/").items()}


def _by_name(table, flat, prefix=""):
    """flax leaves -> {torch name: tensor} through the table's transforms."""
    return {table[prefix + k][0]: torch.from_numpy(
        np.ascontiguousarray(table[prefix + k][1](v))) for k, v in flat.items()}


FAMILIES = {
    "uncrtaints": dict(encoder_widths=[16], decoder_widths=[16, 16], n_head=4, d_model=32,
                       scale_by=10.0),
    "uncrtaints_residual_use_v": dict(block_type="residual", use_v=True, separate_out=True,
                                      covmode="iso", encoder_widths=[16],
                                      decoder_widths=[16, 16], n_head=4, d_model=32),
    **{k: v for k, v in MODELS.items() if k != "utae_mean_nonlin"},  # a variant of utae
    **{name: dict(model=name) for name in ("uconvlstm", "buconvlstm", "convlstm", "convgru",
                                           "fpn")},
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_family_loads_from_a_jax_ckpt(name, tmp_path):
    """init -> the JAX save_checkpoint -> the port's load_checkpoint: the
    state dict is the JAX variables mapped, bit for bit, and the eval
    forward gives the JAX forward's output within 1e-5 RMSE."""
    from uncrtaints_tpu.train.checkpoint import save_checkpoint as jax_save
    from uncrtaints_tpu.train.engine import TrainState, make_optimizer
    model, v, _, tcfg, jcfg = pair(FAMILIES[name], np.random.default_rng(0))
    jcfg = jcfg.replace(res_dir=str(tmp_path), experiment_name="fam")
    tcfg = tcfg.replace(res_dir=str(tmp_path), experiment_name="fam")
    tx = make_optimizer(jcfg.lr)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v.get("batch_stats", {}), opt_state=tx.init(v["params"]),
                    freeze_mask=None, apply_fn=model.apply, tx=tx)
    jax_save(jcfg, 1, st, "model", jcfg.lr)
    fresh = tcfg.replace(rdm_seed=77)
    ts, meta = load_checkpoint(tcfg, str(tmp_path),
                               create_train_state(fresh, get_generator(fresh)), "model")
    assert meta["epoch"] == 1 and ts.opt_state.count == 0
    table = jax_to_torch_names(tcfg)
    want = _by_name(table, _flat(v["params"]))
    want.update(_by_name(table, _flat(v.get("batch_stats", {})), "B:"))
    sd = ts.model.state_dict()
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in sd)
    b = pair_batch(np.random.default_rng(1), jcfg)
    ref = apply(model, v, b)
    with torch.no_grad():
        got = ts.model.eval()(torch.from_numpy(b["x"]),
                              batch_positions=torch.from_numpy(b["dates"]))
    assert got.shape == ref.shape and rmse(got, ref) <= 1e-5, rmse(got, ref)
