"""The port's whole-scene inference against the JAX package's, on the CPU.

Mirrors tests/test_infer.py: the crossfade ramp, the window origins, a
single-window scene against the direct forward, a tiled scene and a narrow
scene against ``uncrtaints_tpu.infer.predict_scene`` on weights carried by
``from_jax_variables`` (fp32, small widths), the rejected odd tile and the
``forward_fn`` route. Bound for the scene parity: 1e-3 RMSE on pred and var
(the repo's whole-model target); fp32 sums in another order leave below
1e-6, and 1e-5 is asserted.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncrtaints_tpu.config import Config, derive, input_dim

from uncrtaints_tpu_torch.infer import _axis_ramp, _window_origins, predict_scene
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables
from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX state, port model) sharing one set of weights, fp32."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state
    cfg = derive(Config(use_sar=True, scale_by=10.0, batch_size=2, lr=1e-3,
                        encoder_widths=[16], decoder_widths=[16, 16], n_head=4,
                        d_model=32, compute_dtype="float32"))
    rng = np.random.default_rng(0)
    batch = {"x": jnp.asarray(rng.random((2, 3, 32, 32, input_dim(cfg)), dtype=np.float32)),
             "y": jnp.asarray(rng.random((2, 1, 32, 32, 13), dtype=np.float32)),
             "dates": jnp.asarray(rng.integers(0, 1500, (2, 3)).astype(np.float32))}
    state = create_train_state(cfg, jax_generator(cfg), jax.random.PRNGKey(0), batch)
    bs = jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5, jnp.float32),
        state.batch_stats)
    state = state.replace(batch_stats=bs)
    model = get_generator(cfg, "cpu")
    model.load_state_dict(from_jax_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, cfg), strict=True)
    return cfg, state, model


def _scene(seed, H, W, C=15, T=3):
    rng = np.random.default_rng(seed)
    return (rng.random((T, H, W, C), dtype=np.float32),
            rng.integers(0, 1500, (T,)).astype(np.float32))


def test_axis_ramp_crossfade_sums_to_one():
    tile, overlap = 32, 8
    w = _axis_ramp(tile, overlap, n_windows=3)
    stride = tile - overlap
    np.testing.assert_allclose(w[stride:] + w[:overlap], 1.0, rtol=1e-6)
    assert (w > 0).all()
    np.testing.assert_array_equal(_axis_ramp(32, 8, n_windows=1), 1.0)
    np.testing.assert_array_equal(_axis_ramp(32, 0, n_windows=3), 1.0)


@pytest.mark.parametrize("args", [(96, 32, 24), (32, 32, 24), (100, 32, 24), (20, 32, 24),
                                  (1024, 256, 192)])
def test_window_origins_cover_and_clamp(args):
    from uncrtaints_tpu.infer import _window_origins as jax_origins
    size, tile, stride = args
    starts = _window_origins(*args)
    assert starts == jax_origins(*args)
    assert starts[0] == 0 and max(s + tile for s in starts) == max(size, tile)
    assert all(b - a <= stride for a, b in zip(starts, starts[1:]))  # no gap


def test_window_origins_examples():
    assert _window_origins(96, 32, 24) == [0, 24, 48, 64]  # last clamped
    assert _window_origins(32, 32, 24) == [0]
    assert len(_window_origins(1024, 256, 192)) == 5


def test_single_window_equals_direct_forward(pair):
    """A scene of exactly one tile is the eval step's forward: bit-equal
    for the same batch shape."""
    cfg, _, model = pair
    scene, dates = _scene(1, 32, 32)
    out = predict_scene(model, cfg, scene, dates, tile=32, overlap=8, batch_size=1,
                        device="cpu")
    batch = {"x": scene[None], "dates": dates[None],
             "y": np.zeros((1, 1, 32, 32, 13), np.float32)}
    direct = make_eval_step(cfg)(model, batch_to_device(batch, "cpu"))
    for k in ("pred", "var"):
        assert out[k].dtype == np.float32 and out[k].shape == (1, 32, 32, 13)
        np.testing.assert_array_equal(out[k], direct[k][:, 0].numpy())


@pytest.mark.parametrize("shape,tile,batch_size,with_dates", [
    ((80, 96), 32, 3, True),    # 3x4 windows, clamped last windows, a padded final batch
    ((64, 64), 32, 8, False),   # 2x2 windows in one half-empty batch, no dates
    ((20, 48), 32, 2, False),   # narrower than the tile: edge-padded and cropped
    ((32, 29), 64, 2, True),    # smaller than the tile: it shrinks to 32, then pads
])
def test_scene_matches_jax_predict_scene(pair, shape, tile, batch_size, with_dates):
    from uncrtaints_tpu.infer import predict_scene as jax_predict_scene
    cfg, state, model = pair
    scene, dates = _scene(2, *shape)
    dates = dates if with_dates else None
    kw = dict(tile=tile, overlap=8, batch_size=batch_size)
    ref = jax_predict_scene(state, cfg, jnp.asarray(scene),
                            None if dates is None else jnp.asarray(dates), **kw)
    got = predict_scene(model, cfg, scene, dates, device="cpu", **kw)
    for k in ("pred", "var"):
        assert got[k].shape == ref[k].shape == (1, *shape, 13)
        assert np.isfinite(got[k]).all()
        rmse = float(np.sqrt(((got[k] - ref[k]) ** 2).mean()))
        assert rmse <= 1e-5, (k, rmse)
    assert (got["var"] > 0).all()


def test_device_defaults_to_the_models_and_tensor_scene(pair):
    cfg, _, model = pair
    scene, dates = _scene(3, 40, 40)
    a = predict_scene(model, cfg, scene, dates, tile=32, overlap=8, batch_size=4)
    b = predict_scene(model, cfg, torch.from_numpy(scene), torch.from_numpy(dates),
                      tile=32, overlap=8, batch_size=4, device=torch.device("cpu"))
    np.testing.assert_array_equal(a["pred"], b["pred"])


def test_mean_only_head_has_no_var():
    cfg = derive(Config(use_sar=True, loss="l2", encoder_widths=[16], decoder_widths=[16],
                        n_head=4, d_model=32, compute_dtype="float32"))
    out = predict_scene(get_generator(cfg, "cpu"), cfg, _scene(4, 32, 40)[0], None, tile=32,
                        overlap=8, batch_size=2)
    assert set(out) == {"pred"} and out["pred"].shape == (1, 32, 40, 13)


def test_odd_tile_rejected(pair):
    cfg, _, model = pair
    with pytest.raises(ValueError, match="even"):
        predict_scene(model, cfg, np.zeros((3, 40, 40, 15), np.float32), None, tile=31)


def test_forward_fn_route(pair):
    """A plain callable in place of the live model: it needs dates and a
    device, always sees the full batch shape and the caller's tile (no
    shrink to a small scene), and its outputs are blended as they are."""
    cfg, _, model = pair
    scene, dates = _scene(5, 40, 56)
    seen = []

    def fwd(x, d):
        seen.append((tuple(x.shape), tuple(d.shape)))
        return {"pred": x[:, :1, ..., 2:15] + d[:, :1, None, None, None] * 0}

    with pytest.raises(ValueError, match="requires `dates`"):
        predict_scene(None, None, scene, None, forward_fn=fwd, device="cpu")
    with pytest.raises(ValueError, match="requires `device`"):
        predict_scene(None, None, scene, dates, forward_fn=fwd)
    out = predict_scene(None, None, scene, dates, tile=32, overlap=8, batch_size=4,
                        forward_fn=fwd, device="cpu")
    assert set(out) == {"pred"}
    assert seen and all(s == ((4, 3, 32, 32, 15), (4, 3)) for s in seen)
    # the crossfade weights sum to one: blending the identity gives it back
    np.testing.assert_allclose(out["pred"][0], scene[0, ..., 2:15], rtol=1e-5, atol=1e-6)
    # a scene smaller than the tile is padded up to it (fixed spatial dims)
    seen.clear()
    small = predict_scene(None, None, scene[:, :20, :24], dates, tile=32, overlap=8,
                          batch_size=2, forward_fn=fwd, device="cpu")
    assert seen == [((2, 3, 32, 32, 15), (2, 3))] and small["pred"].shape == (1, 20, 24, 13)
