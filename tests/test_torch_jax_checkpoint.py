"""The JAX package's own checkpoints in the port, on the CPU.

The JAX side writes through ``uncrtaints_tpu.train.checkpoint.save_checkpoint``
(a flax msgpack ``.ckpt`` and its ``.meta.json``); the port reads through its
own code (``train/flax_format.py``, ``models/jax_bridge.py``,
``train/checkpoint.py``). Held here: the codec against flax's on JAX-written
files, on a fixed tree of every leaf type (to the byte), on chunked arrays
and bfloat16 leaves, and on malformed input; the paper recipe at small
widths after two JAX train steps through ``load_checkpoint`` (the eval step
against the JAX eval step at fp32, Adam's state bit for bit, one more train
step against the JAX step), ``restore_opt=False``, a legacy ``Conv_0`` tree,
``load_pretrained_partial``, the JAX package reading the port's
``save_jax_checkpoint``, the search order, the ``.orbax`` refusal,
``cli.test`` and ``cli.train --resume_from`` on a directory the JAX
``cli.train`` wrote. Every family ``get_generator`` builds:
tests/test_torch_jax_checkpoint_families.py.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
from flax import serialization as fs

from uncrtaints_tpu import config as jc

from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import (
    jax_to_torch_names, params_table, to_jax_variables)
from uncrtaints_tpu_torch.train import (
    batch_to_device, create_train_state, make_eval_step, make_train_step)
from uncrtaints_tpu_torch.train import flax_format as ff
from uncrtaints_tpu_torch.train.checkpoint import (
    load_checkpoint, load_pretrained_partial, save_checkpoint, save_jax_checkpoint)

from _torch_pairs import rmse

LR, LR_SAVED = 1e-3, 8e-4
# the paper recipe at the tests' small widths; patch = low_res_size, so
# neither package upsamples the attention and no dropout runs
SMALL = dict(use_sar=True, scale_by=10.0, encoder_widths=[16], decoder_widths=[16, 16],
             n_head=4, d_model=32, low_res_size=16, compute_dtype="float32", lr=LR,
             batch_size=2)


def _cfgs(root, experiment="jx", **kw):
    """(JAX config, port config on the CPU) of one run directory."""
    kw = dict(SMALL, res_dir=root, experiment_name=experiment, **kw)
    return jc.derive(jc.Config(**kw)), derive(Config(device="cpu", **kw))


def _batch(rng, B=2, T=3, H=16):
    return {"x": rng.random((B, T, H, H, 15)).astype(np.float32),
            "y": rng.random((B, 1, H, H, 13)).astype(np.float32),
            "dates": rng.integers(0, 1500, (B, T)).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _copy(tree):
    """A copy of a JAX state whose buffers a donating step may consume."""
    return jax.tree.map(lambda a: jnp.array(np.asarray(a)), tree)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree), sep="/").items()}


def _by_name(table, flat, prefix=""):
    """flax leaves -> {torch name: tensor} through the table's transforms."""
    return {table[prefix + k][0]: torch.from_numpy(
        np.ascontiguousarray(table[prefix + k][1](v))) for k, v in flat.items()}


def _fresh_port(tcfg, seed=77):
    c = tcfg.replace(rdm_seed=seed)
    return create_train_state(c, get_generator(c))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's run directory: the paper recipe (small widths)
    after two train steps at lr 1e-3, the lr then set to 8e-4 and saved as
    epoch 2 (``model.ckpt`` + ``model.meta.json``)."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state as jax_state
    from uncrtaints_tpu.train import make_train_step as jax_step
    from uncrtaints_tpu.train import set_learning_rate as jax_lr
    from uncrtaints_tpu.train.checkpoint import save_checkpoint as jax_save
    root = str(tmp_path_factory.mktemp("jax_run"))
    jcfg, tcfg = _cfgs(root)
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(3)]
    st = jax_state(jcfg, jax_generator(jcfg), jax.random.PRNGKey(0), _jb(batches[0]))
    step = jax_step(jcfg)
    for i in range(2):
        st, _ = step(st, _jb(batches[i]), jax.random.PRNGKey(i + 1))
    st = jax_lr(st, LR_SAVED)
    path = jax_save(jcfg, 2, _copy(st), "model", LR_SAVED)
    assert path.endswith("jx/model.ckpt") and int(st.step) == 2
    return types.SimpleNamespace(root=root, jcfg=jcfg, tcfg=tcfg, state=st, batches=batches,
                                 path=path, table=jax_to_torch_names(tcfg))


# ------------------------------------------------------------- codec --

def _assert_same_tree(got, want, path=""):
    """A tree of the port's codec equals flax's: structure, types, dtypes
    and bits (a bfloat16 leaf as its uint16 bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        bits = (got.view(np.ndarray) if isinstance(got, ff.BFloat16)
                else np.asarray(got).view(np.uint16) if got.dtype == jnp.bfloat16 else None)
        assert bits is not None and got.shape == np.shape(want), path
        np.testing.assert_array_equal(bits, np.asarray(want).view(np.uint16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got), got.dtype)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _every_leaf():
    """A tree of every leaf type flax writes, keys in sorted order (as
    ``msgpack_serialize`` copies a tree: JAX sorts dict keys)."""
    rng = np.random.default_rng(3)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1,
            -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {
        "arrays": {
            "bf16": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16),
            "bool": np.array([True, False, True]),
            "empty": np.zeros((0, 4), np.float32),
            "f16": rng.standard_normal(5).astype(np.float16),
            "f32": rng.standard_normal((3, 4)).astype(np.float32),
            "f64": rng.standard_normal((2, 2)),
            "i16": np.arange(-3, 3, dtype=np.int16),
            "i32_0d": np.asarray(7, np.int32),
            "i64": np.arange(4, dtype=np.int64) - 2 ** 40,
            "i8": np.arange(-4, 4, dtype=np.int8),
            "u16": np.arange(4, dtype=np.uint16),
            "u32": np.arange(4, dtype=np.uint32),
            "u64": np.array([2 ** 64 - 1], np.uint64),
            "u8": np.arange(300, dtype=np.int64).astype(np.uint8),
        },
        "bin": b"\x00\x01" * 200,
        "complex": 1.5 - 2j,
        "false": False,
        "float": 0.1,
        "ints": ints,
        "long_list": list(range(20)),
        "map16": {f"k{i:02d}": i for i in range(20)},
        "none": None,
        "scalars": {"f32": np.float32(2.5), "i8": np.int8(-3), "u64": np.uint64(2 ** 63)},
        "str": "x" * 40,
        "str_utf8": "é",
        "true": True,
    }
    port = jax.tree_util.tree_map(lambda x: x, tree)
    port["arrays"]["bf16"] = np.asarray(tree["arrays"]["bf16"]).view(np.uint16).view(ff.BFloat16)
    return tree, port


def test_codec_reads_what_the_jax_package_wrote(run):
    with open(run.path, "rb") as f:
        data = f.read()
    _assert_same_tree(ff.restore(data), fs.msgpack_restore(data))


def test_codec_writes_flax_bytes_and_flax_reads_them():
    tree, port = _every_leaf()
    want = fs.msgpack_serialize(tree)
    got = ff.serialize(port)
    assert got == want, (len(got), len(want))
    _assert_same_tree(fs.msgpack_restore(got), fs.msgpack_restore(want))
    _assert_same_tree(ff.restore(want), fs.msgpack_restore(want))


def test_codec_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes go as flax's chunked maps, both
    ways (the limit made small)."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.standard_normal((10, 7)).astype(np.float32)},
            "bf": jnp.asarray(rng.standard_normal(50), jnp.bfloat16),
            "small": np.arange(3, dtype=np.int32)}
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(ff.restore(data), fs.msgpack_restore(data))
    port = {"a": {"w": tree["a"]["w"]},
            "bf": np.asarray(tree["bf"]).view(np.uint16).view(ff.BFloat16),
            "small": tree["small"]}
    assert ff.serialize(port, max_chunk=64) == data


def test_codec_bfloat16_leaves_reach_torch_bits():
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    leaf = ff.restore(fs.msgpack_serialize({"a": a}))["a"]
    t = ff.to_tensor(leaf.T)  # a view keeps the class
    want = torch.from_numpy(np.asarray(a, np.float32).T.copy()).to(torch.bfloat16)
    assert t.dtype == torch.bfloat16 and torch.equal(t, want)
    back = fs.msgpack_restore(ff.serialize({"a": want}))["a"]
    assert back.dtype == jnp.bfloat16 and np.array_equal(np.asarray(back, np.float32),
                                                          want.float().numpy())


def _bad_inputs():
    good = fs.msgpack_serialize({"w": np.arange(6, dtype=np.float32), "n": 3})
    three = fs.msgpack_serialize({"w": np.zeros(3, np.float32)})
    return {
        "truncated": (good[:-3], "truncated at offset"),
        "trailing": (good + b"\x00", "after the tree at offset"),
        "unknown_ext": (b"\x81\xa1a\xd4\x05\x00", "unknown extension type 5 at offset 3"),
        "unknown_byte": (b"\x92\x01\xc1", "unknown type byte 0xc1 at offset 2"),
        # the shape says 4 floats, the bytes hold 3
        "ndarray_size": (three.replace(b"\x91\x03", b"\x91\x04", 1), "holds 12 bytes"),
        "empty": (b"", "truncated at offset 0"),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_codec_malformed_input_raises_value_error(case):
    data, match = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        ff.restore(data)


# --------------------------------------------- the JAX run in the port --

def test_load_checkpoint_gives_the_jax_eval_step_and_adams_state(run, capsys):
    """load_checkpoint of the JAX ``model.ckpt``: the port's eval step
    equals the JAX eval step (fp32: loss within 1e-5 relative, pred and var
    RMSE within 1e-5 of their max), Adam's moments and count equal the JAX
    tree mapped, bit for bit, and lr, step and epoch are the sidecar's."""
    from uncrtaints_tpu.train import make_eval_step as jax_eval
    state, meta = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model")
    assert "model.ckpt" in capsys.readouterr().out
    with open(run.path.replace(".ckpt", ".meta.json")) as f:
        side = json.load(f)
    assert side == {"epoch": 2, "lr": LR_SAVED, "step": 2}
    assert meta == side and state.step == 2 and state.tx.lr == LR_SAVED
    adam = run.state.opt_state.inner_state[0]
    assert state.opt_state.count == int(adam.count) == 2
    sd = state.model.state_dict()
    want = _by_name(run.table, _flat(run.state.params))
    want.update(_by_name(run.table, _flat(run.state.batch_stats), "B:"))
    assert set(want) == set(sd) and all(torch.equal(sd[k], want[k]) for k in sd)
    for moments in ("mu", "nu"):
        want = _by_name(run.table, _flat(getattr(adam, moments)))
        got = getattr(state.opt_state, moments)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
        assert any(bool(v.abs().max() > 0) for v in got.values())

    b = run.batches[2]
    got = make_eval_step(run.tcfg)(state.model, batch_to_device(b, "cpu"))
    ref = jax_eval(run.jcfg)(_copy(run.state), _jb(b))
    assert abs(float(got["loss"]) / float(ref["loss"]) - 1) <= 1e-5
    for k in ("pred", "var"):
        r = np.asarray(ref[k])
        assert rmse(got[k].numpy(), r) <= 1e-5 * np.abs(r).max(), k


def _step_gap(ts, aux, jnew, table):
    """The worst breach of the train-step parity bounds of
    tests/test_torch_train.py (moments within 1e-4 of their max, each
    parameter within 1e-3 lr where its gradient is above 1e-3 of its max;
    gradients that are rounding noise skipped), as a fraction of its bound:
    <= 1 passes."""
    mu = _by_name(table, _flat(jnew.opt_state.inner_state[0].mu))
    nu = _by_name(table, _flat(jnew.opt_state.inner_state[0].nu))
    new_p = _by_name(table, _flat(jnew.params))
    gmax = max(float(g.abs().max()) for g in aux["grads"].values())
    worst = 0.0
    for n, p in ts.model.named_parameters():
        g = aux["grads"][n].abs()
        if float(g.max()) <= 1e-6 * gmax:
            continue
        for got, ref in ((ts.opt_state.mu[n], mu[n]), (ts.opt_state.nu[n], nu[n])):
            worst = max(worst, float((got - ref).abs().max()) / (1e-4 * float(ref.abs().max())))
        big = g > 1e-3 * g.max()
        worst = max(worst, float((p.detach() - new_p[n]).abs()[big].max()) / (1e-3 * LR_SAVED))
    return worst


def test_the_next_train_step_agrees_and_sees_the_moments(run):
    """One more step in each package from the checkpoint agrees within the
    train-step bounds; a port step from zero moments does not."""
    from uncrtaints_tpu.train import make_train_step as jax_step
    b = run.batches[2]
    jnew, jaux = jax_step(run.jcfg)(_copy(run.state), _jb(b), jax.random.PRNGKey(9))
    step = make_train_step(run.tcfg)
    gaps = []
    for zero in (False, True):
        ts, _ = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model")
        if zero:
            for t in (*ts.opt_state.mu.values(), *ts.opt_state.nu.values()):
                t.zero_()
            ts.opt_state.count = 0
        ts, aux = step(ts, batch_to_device(b, "cpu"))
        assert abs(float(aux["loss"]) / float(jaux["loss"]) - 1) <= 1e-5
        gaps.append(_step_gap(ts, aux, jnew, run.table))
    print(f"the next train step against the JAX step, worst gap over its bound: restored "
          f"moments {gaps[0]:.3g}, zero moments {gaps[1]:.3g}")
    assert gaps[0] <= 1 < gaps[1], gaps


def test_restore_opt_false_restores_the_model_and_the_step(run):
    state, meta = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model",
                                  restore_opt=False)
    assert meta["epoch"] == 2 and state.step == 2
    assert state.opt_state.count == 0 and state.tx.lr == LR
    assert all(not m.any() for m in (*state.opt_state.mu.values(), *state.opt_state.nu.values()))
    full, _ = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model")
    a, b = state.model.state_dict(), full.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_legacy_conv_tree_loads(run, tmp_path):
    """A file of the JAX package's older layout (``Conv2d_i/Conv_0/kernel``,
    built as tests/test_engine.py builds it) loads as the current one."""
    def wrap(tree, under_conv=False):
        if not isinstance(tree, dict):
            return tree
        out = {k: wrap(v, under_conv=isinstance(k, str) and k.startswith("Conv2d"))
               for k, v in tree.items()}
        if under_conv and ("kernel" in out or "bias" in out):
            return {"Conv_0": out}
        return out

    with open(run.path, "rb") as f:
        raw = fs.msgpack_restore(f.read())
    legacy = wrap(raw)
    assert legacy != raw
    exp = tmp_path / "jx"
    exp.mkdir()
    (exp / "model.ckpt").write_bytes(fs.msgpack_serialize(legacy))
    shutil.copyfile(run.path.replace(".ckpt", ".meta.json"), exp / "model.meta.json")
    old, _ = load_checkpoint(run.tcfg, str(tmp_path), _fresh_port(run.tcfg), "model")
    new, _ = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model")
    for a, b in ((old.model.state_dict(), new.model.state_dict()),
                 (old.opt_state.mu, new.opt_state.mu), (old.opt_state.nu, new.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_partial_transfer_from_a_ckpt_matches_the_jax_package(run):
    """load_pretrained_partial of the ``.ckpt``: the parameters the JAX
    function gives (mapped by name), and its freeze mask's frozen set."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state as jax_state
    from uncrtaints_tpu.train.checkpoint import load_pretrained_partial as jax_partial
    jst = jax_state(run.jcfg, jax_generator(run.jcfg), jax.random.PRNGKey(5),
                    _jb(run.batches[0]))
    jst, jmask = jax_partial(run.jcfg, jst, run.path)
    ts, mask = load_pretrained_partial(run.tcfg, _fresh_port(run.tcfg), run.path)
    sd = ts.model.state_dict()
    want = _by_name(run.table, _flat(jst.params))
    assert all(torch.equal(sd[k], v) for k, v in want.items())
    # batch-norm statistics transfer too in the port (by name, by design)
    stats = _by_name(run.table, _flat(run.state.batch_stats), "B:")
    assert all(torch.equal(sd[k], v) for k, v in stats.items())
    frozen = {run.table[k][0] for k, m in _flat(jmask).items() if float(m) == 0.0}
    assert {n for n, m in mask.items() if m == 0.0} == frozen
    assert set(mask) - frozen == {n for n in mask if "out_conv" in n}

    # a wider attention (which the JAX function's strict restore refuses):
    # the port copies what matches by name and shape and leaves the rest
    _, wide = _cfgs(run.root, d_model=64)
    ts = _fresh_port(wide)
    init = {k: v.clone() for k, v in ts.model.state_dict().items()}
    ts, mask = load_pretrained_partial(wide, ts, run.path)
    sd = ts.model.state_dict()
    src = {**want, **stats}
    copied = {k for k in sd if src[k].shape == sd[k].shape}
    assert any("temporal_encoder" in k for k in set(sd) - copied)
    assert all(torch.equal(sd[k], src[k] if k in copied else init[k]) for k in sd)
    assert {n for n, m in mask.items() if m == 0.0} == {
        n for n in mask if n in copied and "out_conv" not in n}


def test_the_jax_package_reads_save_jax_checkpoint(run, tmp_path):
    """save_jax_checkpoint of a port state two steps in: the JAX
    load_checkpoint restores params, batch_stats, opt_state and step bit for
    bit. And the JAX run's file, loaded here and written back, is the same
    bytes (its sidecar too)."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state as jax_state
    from uncrtaints_tpu.train.checkpoint import load_checkpoint as jax_load
    jcfg, tcfg = _cfgs(str(tmp_path), "port")
    ts = _fresh_port(tcfg, seed=3)
    step = make_train_step(tcfg)
    for b in run.batches[:2]:
        ts, _ = step(ts, batch_to_device(b, "cpu"))
    path = save_jax_checkpoint(tcfg, 3, ts, "model_epoch_3", 5e-4)
    assert sorted(os.listdir(os.path.dirname(path))) == ["model_epoch_3.ckpt",
                                                         "model_epoch_3.meta.json"]
    template = jax_state(jcfg, jax_generator(jcfg), jax.random.PRNGKey(8), _jb(run.batches[0]))
    got, meta = jax_load(jcfg, str(tmp_path), template, "model_epoch_3")
    assert meta == {"epoch": 3, "lr": 5e-4, "step": 2} and int(got.step) == 2
    want = to_jax_variables(ts.model.state_dict(), tcfg)
    moments = params_table(run.table)
    for key, tree in (("params", got.params), ("batch_stats", got.batch_stats)):
        a, b = _flat(tree), _flat(want[key])
        assert set(a) == set(b) and all(a[k].tobytes() == b[k].tobytes() for k in a), key
    inj = got.opt_state
    assert int(inj.count) == int(inj.inner_state[0].count) == ts.opt_state.count == 2
    # the file holds the state's lr; the JAX load sets the sidecar's over it
    assert float(inj.hyperparams["learning_rate"]) == np.float32(5e-4)
    with open(path, "rb") as f:
        hyper = fs.msgpack_restore(f.read())["opt_state"]["hyperparams"]
    assert {k: float(v) for k, v in hyper.items()} == {
        "b1": np.float32(0.9), "b2": np.float32(0.999), "eps": np.float32(1e-8),
        "eps_root": 0.0, "learning_rate": np.float32(ts.tx.lr)}
    from uncrtaints_tpu_torch.models.jax_bridge import to_table
    for name in ("mu", "nu"):
        a = _flat(getattr(inj.inner_state[0], name))
        b = _flat(to_table(getattr(ts.opt_state, name), moments)["params"])
        assert set(a) == set(b) and all(a[k].tobytes() == b[k].tobytes() for k in a), name

    back, _ = load_checkpoint(run.tcfg, run.root, _fresh_port(run.tcfg), "model")
    again = save_jax_checkpoint(run.tcfg.replace(res_dir=str(tmp_path)), 2, back, "model",
                                LR_SAVED)
    for suffix in (".ckpt", ".meta.json"):
        with open(run.path.replace(".ckpt", suffix), "rb") as f, \
                open(again.replace(".ckpt", suffix), "rb") as g:
            assert f.read() == g.read(), suffix


def test_search_order_prefers_the_ports_own_files(run, tmp_path, capsys):
    """In one directory ``model.pth.tar`` wins over the JAX ``model.ckpt``;
    without it the ``.ckpt`` is read."""
    exp = tmp_path / "jx"
    exp.mkdir()
    for suffix in (".ckpt", ".meta.json"):
        shutil.copyfile(run.path.replace(".ckpt", suffix), exp / f"model{suffix}")
    tcfg = run.tcfg.replace(res_dir=str(tmp_path))
    own = _fresh_port(tcfg, seed=4)
    save_checkpoint(tcfg, 5, own, "model", 1e-4)
    capsys.readouterr()
    got, meta = load_checkpoint(tcfg, str(tmp_path), _fresh_port(tcfg), "model")
    assert "model.pth.tar" in capsys.readouterr().out and meta["epoch"] == 5
    a, b = got.model.state_dict(), own.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    os.remove(exp / "model.pth.tar")
    got, meta = load_checkpoint(tcfg, str(tmp_path), _fresh_port(tcfg), "model")
    assert "model.ckpt" in capsys.readouterr().out and meta["epoch"] == 2


def test_an_orbax_directory_is_still_refused_with_the_route(run, tmp_path):
    os.makedirs(tmp_path / "jx" / "model.orbax")
    tcfg = run.tcfg.replace(res_dir=str(tmp_path))
    with pytest.raises(ValueError, match="save it there with ckpt_backend='msgpack'"):
        load_checkpoint(tcfg, str(tmp_path), _fresh_port(tcfg), "model")
    with pytest.raises(ValueError, match="OCDBT"):
        load_pretrained_partial(tcfg, _fresh_port(tcfg), str(tmp_path / "jx" / "model.orbax/"))


def test_adam_hyperparameters_of_another_adam_raise(run, tmp_path):
    with open(run.path, "rb") as f:
        tree = fs.msgpack_restore(f.read())
    tree["opt_state"]["hyperparams"]["b2"] = np.asarray(0.99, np.float32)
    (tmp_path / "jx").mkdir()
    (tmp_path / "jx" / "model.ckpt").write_bytes(fs.msgpack_serialize(tree))
    with pytest.raises(ValueError, match="b2"):
        load_checkpoint(run.tcfg, str(tmp_path), _fresh_port(run.tcfg), "model")
    # without a sidecar: epoch 1, the saved learning rate
    state, meta = load_checkpoint(run.tcfg, str(tmp_path), _fresh_port(run.tcfg), "model",
                                  restore_opt=False)
    assert meta == {"epoch": 1, "lr": float(np.float32(LR_SAVED)), "step": 2}


# ------------------------------------------------ the CLIs on a JAX run --

# a batch of 8: the JAX CLI splits it over the 8 virtual CPU devices
CLI = dict(use_sar=True, scale_by=10.0, batch_size=8, lr=1e-3, input_t=3, max_samples_count=8,
           synthetic_data=True, synthetic_patch=32, encoder_widths=[16],
           decoder_widths=[16, 16], n_head=4, d_model=32, compute_dtype="float32",
           plot_every=-1, export_every=-1, display_step=1)


@pytest.fixture(scope="module")
def jax_cli_run(tmp_path_factory):
    """The JAX ``cli.train`` (synthetic data, 32x32, one epoch) and the JAX
    ``cli.test`` of its directory."""
    from uncrtaints_tpu.cli import test as jax_test, train as jax_train
    root = tmp_path_factory.mktemp("jax_cli")
    res = str(root / "results")
    jax_train.main(jc.derive(jc.Config(epochs=1, res_dir=res, experiment_name="jrun", **CLI)))
    argv = ["--experiment_name", "jrun", "--weight_folder", res, "--max_samples_count", "8",
            "--batch_size", "8", "--input_t", "3", "--export_every", "-1", "--plot_every", "-1"]
    metrics = jax_test.main(jax_test.load_test_config(argv + ["--res_dir", str(root / "jt")]))
    return types.SimpleNamespace(root=root, res=res, argv=argv, metrics=metrics)


def test_cli_test_on_a_jax_run_directory(jax_cli_run):
    """The port's cli.test on the directory the JAX cli.train wrote (its
    conf.json and model.ckpt): the JAX cli.test's metrics within 1e-5."""
    from uncrtaints_tpu_torch.cli import test as cli_test
    r = jax_cli_run
    assert {"conf.json", "model.ckpt", "model.meta.json"} <= set(os.listdir(
        os.path.join(r.res, "jrun")))
    cfg = cli_test.load_test_config(r.argv + ["--res_dir", str(r.root / "pt"), "--device",
                                              "cpu"])
    assert cfg.compute_dtype == "float32" and cfg.encoder_widths == [16]
    got = cli_test.main(cfg)
    assert set(got) == set(r.metrics)
    for k, v in r.metrics.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, got[k], v)


def test_cli_train_resumes_from_a_jax_ckpt(jax_cli_run, monkeypatch):
    """``cli.train --resume_from --trained_checkp .../model_epoch_1.ckpt``
    in the JAX run's directory: the second epoch goes on from the JAX
    step, Adam count and schedule, and the port writes its own files."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from uncrtaints_tpu_torch.cli import train as cli_train
    from uncrtaints_tpu_torch.config import apply_resume
    from uncrtaints_tpu_torch.train import epoch_lr
    r = jax_cli_run
    exp = os.path.join(r.res, "jrun")
    ckpt = os.path.join(exp, "model_epoch_1.ckpt")
    with open(ckpt.replace(".ckpt", ".meta.json")) as f:
        side = json.load(f)
    cfg = apply_resume(derive(Config(device="cpu", epochs=2, res_dir=r.res,
                                     experiment_name="jrun", resume_from=True,
                                     trained_checkp=ckpt, resume_at=1, **CLI)))
    out = cli_train.main(cfg)
    assert set(map(int, out["trainlog"])) == {2}
    blob = torch.load(os.path.join(exp, "model_epoch_2.pth.tar"), weights_only=True)
    n_batches = 1
    assert blob["epoch"] == 2 and blob["step"] == side["step"] + n_batches
    assert blob["optimizer_G"]["count"] == side["step"] + n_batches
    assert blob["lr"] == epoch_lr(cfg, 1)
    assert all(np.isfinite(v) for v in out["test"].values())
