"""Shared helpers of the baseline parity tests (tests/test_torch_baselines.py,
test_torch_utae.py, test_torch_recurrent.py): a JAX model and the port's on
one set of weights, a seeded batch, the JAX forward jitted, dropout off."""

import numpy as np

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp

from uncrtaints_tpu.config import Config, derive

from uncrtaints_tpu_torch.config import Config as PortConfig, derive as port_derive
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables

SMALL = dict(encoder_widths=[8, 8, 8, 16], decoder_widths=[8, 8, 8, 16], n_head=4, d_model=16)
MODELS = {
    "unet": dict(model="unet", **SMALL),
    "utae": dict(model="utae", **SMALL),
    "utae_pretrain": dict(model="utae", pretrain=True, **SMALL),
    "utae_mean_nonlin": dict(model="utae", mean_nonLinearity=True, scale_by=10.0, **SMALL),
    "unet3d": dict(model="unet3d", input_t=4),
}


def configs(**kw):
    """(JAX config, port config on the CPU) of one model, fp32."""
    kw = dict(use_sar=True, compute_dtype="float32", **kw)
    return derive(Config(**kw)), port_derive(PortConfig(device="cpu", **kw))


def batch(rng, cfg, B=2, H=32):
    T = cfg.input_t
    x = rng.random((B, T, H, H, 15)).astype(np.float32)
    if T > 2:
        x[1, -1] = 0.0  # an all-pad frame
    return {"x": x, "y": rng.random((B, 1, H, H, 13)).astype(np.float32),
            "dates": rng.integers(0, 1500, (B, T)).astype(np.float32)}


def pair(kw, rng, H=32):
    """(JAX module, its variables with random batch statistics, port model
    with the same weights, port config, JAX config)."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    jcfg, tcfg = configs(**kw)
    b = batch(rng, jcfg, H=H)
    model = jax_generator(jcfg)
    init = jax.jit(lambda key, x, d: model.init(key, x, batch_positions=d))
    v = flax.core.unfreeze(init(jax.random.PRNGKey(0), jnp.asarray(b["x"]),
                                jnp.asarray(b["dates"])))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5, jnp.float32),
            v["batch_stats"])
    port = get_generator(tcfg, "cpu")
    port.load_state_dict(from_jax_variables(v, tcfg), strict=True)
    return model, v, port, tcfg, jcfg


def apply(model, v, b, train=False):
    """The JAX model's forward on batch b, jitted (the eager interpreter is
    several times slower on these graphs); with ``train`` the batch
    statistics are used and updated, and every dropout passes its input."""
    def f(v, x, d):
        with fnn.intercept_methods(_no_dropout):
            return model.apply(v, x, batch_positions=d, train=train,
                               mutable=["batch_stats"] if train else False)
    return jax.jit(f)(v, jnp.asarray(b["x"]), jnp.asarray(b["dates"]))


def rmse(a, b):
    return float(np.sqrt(((np.asarray(a) - np.asarray(b)) ** 2).mean()))


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every ``nn.Dropout`` passes its input through."""
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def port_without_dropout(port):
    te = getattr(port, "temporal_encoder", None)
    if te is not None and hasattr(te, "use_dropout"):
        te.use_dropout, te.dropout = False, 0.0
    return port
