"""The spans and counters inside the port's steps (``uncrtaints_tpu_torch/tracing.py``)
and the benchmark's readers of them (``bench_h100/metrics/device_ms.py``,
``mb.py``).

On the CPU, at a tiny paper recipe and a tiny U-TAE: with no profiler no
record is made and the steps equal, bit for bit, the steps written out as
they were before the spans; under ``torch.profiler`` each step closes one
record with its sections in order, the ``uncrtaints.*`` events nest under
the step's own on its thread and are operator events, never user
annotations; the ``cast`` and ``reflect_pad`` counters equal the bytes the
shapes give. One test is marked ``cuda``: on the card the tracer adds no
device operation. The file imports neither JAX nor the conftest, so on a
GPU machine without JAX it runs as

    python -m pytest tests/test_torch_tracing.py --noconftest -m cuda
"""

import contextlib
import copy
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.func import functional_call
from torch.profiler import ProfilerActivity, profile

from uncrtaints_tpu_torch import tracing
from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.losses import calc_loss, get_loss
from uncrtaints_tpu_torch.models import layers
from uncrtaints_tpu_torch.models.registry import get_generator
from uncrtaints_tpu_torch.train.engine import (
    _split_out, create_train_state, make_eval_step, make_train_step)

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench_h100 import harness  # noqa: E402

FAMILIES = {
    "paper": dict(use_sar=True, scale_by=10.0, encoder_widths=[16], decoder_widths=[16, 16],
                  n_head=4, d_model=32, low_res_size=8),
    "utae": dict(model="utae", use_sar=True, encoder_widths=[8, 8, 8, 16],
                 decoder_widths=[8, 8, 8, 16], n_head=4, d_model=16),
}
SECTIONS = {"paper": ["encoder", "ltae", "aggregate", "decoder"],
            "utae": ["encoder", "ltae"] + ["aggregate", "decoder"] * 3 + ["decoder"]}
B, T, S = 2, 3, 32
NEW_METRICS = [m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
               if m["name"].split(".")[0].endswith(("_device_ms", "_mb"))]


@pytest.fixture(autouse=True)
def no_records():
    tracing.take()
    yield
    tracing.take()


def _setup(family, device="cpu"):
    cfg = derive(Config(**FAMILIES[family], device=device))
    torch.manual_seed(0)
    model = get_generator(cfg, device=torch.device(device))
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.rand(B, T, S, S, 15, generator=g),
             "y": torch.rand(B, 1, S, S, 13, generator=g),
             "dates": torch.floor(1500 * torch.rand(B, T, generator=g))}
    return cfg, model, {k: v.to(device) for k, v in batch.items()}


def _written_out_eval(cfg, model, batch):
    """The eval step as it was written before the spans."""
    s, dt = cfg.scale_by, torch.bfloat16
    with torch.inference_mode():
        model.eval()
        y = batch["y"].to(torch.float32)
        x, y_s = s * batch["x"].to(torch.float32), s * y
        params = {n: p.to(dt) if p.is_floating_point() else p
                  for n, p in model.named_parameters()}
        out = functional_call(model, params, (x.to(dt),), {"batch_positions": batch["dates"]})
        mean, var = _split_out(out.float(), cfg)
        loss, variance = calc_loss(get_loss(cfg), cfg, mean, y_s, var=var)
        aux = {"loss": loss, "pred": mean / s}
        if variance is not None:
            aux["var"] = variance / (s * s)
        return aux


def _written_out_train(cfg, state, batch, gen):
    """The train step (no accumulation, one process) as it was written
    before the spans: loss, pred, var, the gradients; updates ``state``."""
    s, dt, model = cfg.scale_by, torch.bfloat16, state.model
    model.train()
    y = batch["y"].to(torch.float32)
    x, y_s = s * batch["x"].to(torch.float32), s * y
    names, masters = map(list, zip(*model.named_parameters()))
    params = {n: p.to(dt) if p.is_floating_point() else p for n, p in model.named_parameters()}
    out = functional_call(model, params, (x.to(dt),),
                          {"batch_positions": batch["dates"], "dropout_generator": gen})
    mean, var = _split_out(out.float(), cfg)
    loss, variance = calc_loss(get_loss(cfg), cfg, mean, y_s, var=var)
    grads = list(torch.autograd.grad(loss, masters))
    torch._foreach_div_(grads, 1.0)
    loss = torch.stack([loss.detach()]).mean()
    state.tx.step_(masters, grads, state.opt_state, names)
    aux = {"loss": loss, "pred": torch.cat([mean.detach()]) / s}
    if variance is not None:
        aux["var"] = torch.cat([variance.detach()]) / (s * s)
    return aux, dict(zip(names, grads))


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("traced", [False, True])
def test_steps_equal_the_written_out_steps(family, traced):
    """No profiler: no record. Either way the outputs, gradients and updated
    parameters are bit for bit the written-out step's."""
    cfg, model, batch = _setup(family)
    twin = copy.deepcopy(model)
    state, twin_state = create_train_state(cfg, model), create_train_state(cfg, twin)
    ev, tr = make_eval_step(cfg), make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        got_eval = ev(model, batch)
        _, got_train = tr(state, batch, torch.Generator().manual_seed(2))
    assert len(tracing.take()) == (2 if traced else 0)
    _assert_bitwise(got_eval, _written_out_eval(cfg, twin, batch))
    want_train, want_grads = _written_out_train(cfg, twin_state, batch,
                                                torch.Generator().manual_seed(2))
    _assert_bitwise({k: v for k, v in got_train.items() if k != "grads"}, want_train)
    _assert_bitwise(got_train["grads"], want_grads)
    _assert_bitwise(dict(model.named_parameters()), dict(twin.named_parameters()))
    _assert_bitwise(dict(model.named_buffers()), dict(twin.named_buffers()))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_records_and_profiler_events(family, tmp_path):
    cfg, model, batch = _setup(family)
    state = create_train_state(cfg, model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        make_eval_step(cfg)(model, batch)
        make_train_step(cfg)(state, batch, torch.Generator().manual_seed(2))
    recs = tracing.steps()
    assert [r.name for r in recs] == ["eval_step", "train_step"]
    assert recs[1].index == recs[0].index + 1
    sections = SECTIONS[family]
    assert [sp.name for sp in recs[0].spans] == ["eval_step", "cast", "cast"] + sections + ["loss"]
    assert [sp.name for sp in recs[1].spans] == (["train_step", "cast", "cast"] + sections
                                                 + ["loss", "backward", "optimizer", "loss"])
    for r in recs:  # flat under the step, in order on the host clock
        assert [sp.parent for sp in r.spans] == [None] + [0] * (len(r.spans) - 1)
        assert all(sp.events is None for sp in r.spans)
        assert all(a.t1 <= b.t0 for a, b in zip(r.spans[1:], r.spans[2:]))
        assert r.spans[0].t0 <= r.spans[1].t0 and r.spans[-1].t1 <= r.spans[0].t1

    events = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    steps = [e for e in events if e.name in ("uncrtaints.eval_step", "uncrtaints.train_step")]
    assert len(steps) == 2 and len(events) == sum(len(r.spans) for r in recs)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        if e in steps:
            continue
        top = e
        while top.cpu_parent is not None:
            top = top.cpu_parent
        assert top in steps and e.thread == top.thread, e.name
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    cats = {ev.get("cat") for ev in json.loads(trace.read_text())["traceEvents"]
            if ev.get("name", "").startswith(tracing.PREFIX)}
    assert cats == {"cpu_op"}


def test_counters_equal_the_shapes(monkeypatch):
    """``cast``: the fp32 x and y scaled (4 bytes each), the bf16 input and
    parameters (2 bytes each); ``reflect_pad``: every padded tensor the
    convolutions write (K7's reflect pad, the eager pad of the other modes;
    the kernels' plain versions pad apart). The paper recipe pads its
    depthwise convs in eval (one a block, encoder on B*T frames, decoder on
    B) and folds them all in a train step; U-TAE pads every 3x3 conv."""
    pads = []
    real_pad, real_reflect = layers.F.pad, layers.reflect_pad

    def pad(x, p, mode="constant", value=None):
        out = real_pad(x, p, mode=mode) if value is None else real_pad(x, p, mode, value)
        if mode != "constant" and sys._getframe(1).f_code is layers.Conv2d.forward.__code__:
            pads.append(out.numel() * out.element_size())
        return out

    def reflect(x, p):
        out = real_reflect(x, p)
        pads.append(out.numel() * out.element_size())
        return out

    monkeypatch.setattr(layers.F, "pad", pad)
    monkeypatch.setattr(layers, "reflect_pad", reflect)
    for family in sorted(FAMILIES):
        cfg, model, batch = _setup(family)
        n_params = sum(p.numel() for p in model.parameters())
        cast = 4 * (B * T * S * S * 15 + B * S * S * 13) + 2 * (B * T * S * S * 15 + n_params)
        state = create_train_state(cfg, model)
        with profile(activities=[ProfilerActivity.CPU]):
            pads.clear()
            make_eval_step(cfg)(model, batch)
            eval_pads = sum(pads)
            pads.clear()
            make_train_step(cfg)(state, batch, torch.Generator().manual_seed(2))
            train_pads = sum(pads)
        ev, tr = tracing.take()
        assert ev.counters["cast"] == tr.counters["cast"] == cast
        assert ev.counters.get("reflect_pad", 0) == eval_pads > 0
        assert tr.counters.get("reflect_pad", 0) == train_pads
        if family == "paper":
            hidden = 2 * cfg.encoder_widths[0]
            block = (S + 2) ** 2 * hidden * 2  # bf16
            assert eval_pads == block * (B * T + B * len(cfg.decoder_widths))
            assert train_pads == 0
        else:
            assert train_pads == eval_pads


def test_gn_chain_counts_the_group_chains_input():
    """``gn_chain``: the bytes of each eval group-norm MBConv's input that ran
    as the kernel chain (the encoder's block on B*T frames, bf16), nothing in
    a train step (train mode keeps the standard body) or with fused_eval
    off; widths of 128, where the chain is taken."""
    cfg = derive(Config(**dict(FAMILIES["paper"], encoder_widths=[128], decoder_widths=[128]),
                        device="cpu", fused_eval="on"))
    torch.manual_seed(0)
    model = get_generator(cfg, device=torch.device("cpu"))
    _, _, batch = _setup("paper")
    state = create_train_state(cfg, model)
    off = derive(Config(**dict(FAMILIES["paper"], encoder_widths=[128], decoder_widths=[128]),
                        device="cpu", fused_eval="off"))
    with profile(activities=[ProfilerActivity.CPU]):
        make_eval_step(cfg)(model, batch)
        make_train_step(cfg)(state, batch, torch.Generator().manual_seed(2))
        make_eval_step(off)(get_generator(off, device=torch.device("cpu")), batch)
    ev, tr, ev_off = tracing.take()
    assert ev.counters["gn_chain"] == B * T * S * S * 128 * 2
    assert "gn_chain" not in tr.counters and "gn_chain" not in ev_off.counters
    assert "reflect_pad" not in ev.counters  # K4 folds the encoder's pad too


def test_counters_need_a_profiler_and_a_step():
    tracing.count("cast", 10)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not tracing.recording()
        tracing.count("cast", 10)
        with tracing.span("cast"):
            tracing.count("cast", 10)
    assert tracing.steps() == []


def test_counter_into_the_record_of_another_thread():
    """Autograd runs a CUDA backward on its own thread: there a counter adds
    to the record its forward took with ``open_record``, and to nothing
    without it."""
    import threading
    model = torch.nn.Linear(1, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.open_record() is None
        with tracing.step("train_step", model):
            rec = tracing.open_record()
            tracing.count("norm_onchip", 3)
            t = threading.Thread(target=lambda: (tracing.count("norm_onchip", 5),
                                                 tracing.count("norm_onchip", 7, rec)))
            t.start()
            t.join()
    (got,) = tracing.take()
    assert got is rec and got.counters == {"norm_onchip": 10}


def test_reader_names():
    """Every new metric resolves to ``device_ms.py`` or ``mb.py``; every other
    name in BENCHMARK.json to the file it resolves to without them."""
    assert len(NEW_METRICS) == 25
    for m in NEW_METRICS:
        want = "mb" if m["name"].split(".")[0].endswith("_mb") else "device_ms"
        assert harness.reader(m["name"]).__module__ == f"bench_h100.metrics.{want}"


def test_existing_names_resolve_as_before(tmp_path):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    before = tmp_path / "metrics"
    shutil.copytree(REPO / "bench_h100" / "metrics", before,
                    ignore=shutil.ignore_patterns("device_ms.py", "mb.py", "__pycache__"))
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]
             if m not in NEW_METRICS]
    assert len(names) == 26
    for name in names:
        assert (harness.reader(name).__module__
                == harness.reader(name, root=tmp_path).__module__), name


def _ctx(name, requests, t1, traced=True):
    return SimpleNamespace(name=name, window={"t1": t1},
                           trace=SimpleNamespace(requests=requests) if traced else None)


def test_readers_on_the_cpu():
    """mb.py reads the counters of the first requests after the timed window;
    device_ms.py finds no device events on the CPU. Both give None without a
    trace or with fewer records than requests."""
    cfg, model, batch = _setup("paper")
    ev = make_eval_step(cfg)
    ev(model, batch)  # before the window's end: not read
    with profile(activities=[ProfilerActivity.CPU]):
        ev(model, batch)
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            ev(model, batch)
    recs = tracing.steps()
    assert len(recs) == 4
    cast = recs[-1].counters["cast"]
    read = harness.reader("cast_mb.eval")
    assert read(_ctx("cast_mb.eval", 2, t1)) == cast / 1e6
    assert harness.reader("reflect_pad_mb.eval")(_ctx("reflect_pad_mb.eval", 3, t1)) > 0
    assert read(_ctx("cast_mb.eval", 4, t1)) is None
    assert read(_ctx("cast_mb.eval", 2, t1, traced=False)) is None
    for name in ("encoder_device_ms.eval", "other_device_ms.eval"):
        assert harness.reader(name)(_ctx(name, 2, t1)) is None


def test_device_ms_self_times():
    """Self time: a span less the spans it names as parent; the step's own is
    ``other``; the reader takes the median over the requests."""
    from bench_h100.metrics import device_ms

    class Ev:
        def __init__(self, ms):
            self.ms = ms

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.ms - self.ms

    def rec(t, spans):
        r = tracing.Step(0, torch.device("cpu"))
        for name, parent, a, b in spans:
            sp = tracing.Span(name, parent, (Ev(a), Ev(b)))
            sp.t0 = sp.t1 = t
            r.spans.append(sp)
        return r

    r = rec(1.0, [("train_step", None, 0, 10), ("encoder", 0, 0, 2), ("backward", 0, 3, 9),
                  ("encoder", 2, 4, 5), ("loss", 0, 9, 9.5)])
    assert device_ms.self_ms(r) == {"other": 1.5, "encoder": 3.0, "backward": 5.0, "loss": 0.5}
    r2 = rec(2.0, [("train_step", None, 0, 4), ("encoder", 0, 0, 1)])
    tracing._closed.extend([r, r2, rec(3.0, [("train_step", None, 0, 1)])])
    assert device_ms.read(_ctx("encoder_device_ms.train", 3, 0.5)) == 1.0
    assert device_ms.read(_ctx("backward_device_ms.train", 3, 0.5)) == 0.0
    assert device_ms.read(_ctx("optimizer_device_ms.train", 3, 0.5)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tracer_adds_no_device_operation(family, monkeypatch):
    """On the card: an eval and a train step under a CUDA-only profiler launch
    the same device operations with the tracer on as with it forced off; the
    CUDA-only profiler turns the spans on (each span's device time read);
    no ``uncrtaints.*`` range reaches the device's timeline of a CPU + CUDA
    profile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model, batch = _setup(family, "cuda")
    state = create_train_state(cfg, model)
    ev, tr = make_eval_step(cfg), make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def run(activities):
        with profile(activities=activities) as prof:
            ev(model, batch)
            tr(state, batch, gen)
            torch.cuda.synchronize()
        return prof.events()

    def device_ops(events):
        return sorted(e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA)

    run([ProfilerActivity.CUDA])  # warm-up
    tracing.take()
    on = device_ops(run([ProfilerActivity.CUDA]))
    recs = tracing.take()
    assert [r.name for r in recs] == ["eval_step", "train_step"]
    for r in recs:
        ms = [sp.device_ms() for sp in r.spans]
        assert all(m is not None and m >= 0 for m in ms) and ms[0] > 0
        assert sum(m for sp, m in zip(r.spans, ms) if sp.parent == 0) <= ms[0] * 1.001 + 0.01
    with monkeypatch.context() as mp:
        mp.setattr(tracing, "span", lambda name: tracing._NULL)
        mp.setattr(tracing, "step", lambda name, model: tracing._NULL)
        mp.setattr(tracing, "recording", lambda: False)
        off = device_ops(run([ProfilerActivity.CUDA]))
    assert tracing.take() == []
    assert on == off and len(on) > 0
    both = run([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    assert not [e.name for e in both if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(tracing.PREFIX)]
    assert {e.name for e in both if e.name.startswith(tracing.PREFIX)} >= {
        "uncrtaints.eval_step", "uncrtaints.train_step", "uncrtaints.encoder"}
