"""Attribute the port's train and eval step of the paper recipe to model
sections and modules on a GPU, for any tree.

    python3 tools/profile_train_h100.py [--root DIR]      (one card)

Builds the paper recipe with seeded weights from the package
``uncrtaints_tpu_torch`` found under ``--root`` (default: this checkout; an
older tree unpacked with ``git archive`` works too), warms up, and runs one
train step and one eval step of B=4, T=3, 256x256 under ``torch.profiler``.
Every device kernel is attributed to the part of the model that launched
it, named "<section> / <module>":

- the section is the program's own innermost span (``uncrtaints_tpu_torch/
  tracing.py``): ``cast``, ``encoder``, ``ltae``, ``aggregate``,
  ``decoder``, ``loss``, ``optimizer``; a tree without the spans has none;
- the module comes from ranges this tool opens around it (module hooks and
  wrappers installed here, nothing in the package): ``Norm2d batch`` /
  ``Norm2d group`` / ``Norm2d instance`` (a Norm2d call, with the activation
  it takes along where the tree fuses it), ``GELU`` (a GELU over a map
  called apart from its norm; the SE's GELU over [N, C] stays with the SE),
  ``ReLU`` (an ``nn.ReLU`` module), ``SE`` (the squeeze-and-excitation
  module); none where no hook covers the kernel;
- ``rest``: neither (the step's own work outside every section).

A backward kernel goes to the part whose forward op created its autograd
node (the profiler's sequence numbers link the two), so the backward splits
by section too, which the program's own step record, one span for the
whole backward, cannot; what no forward op of a part created counts as
``rest``. Printed for each step: device-busy ms and kernels, then each
part's device ms and launches (forward / backward) and its ms by kind
(``chip_smoke.KERNEL_KINDS``). Nothing is checked: it compares two trees in one
call on one card (PERF.md section 5).
"""

import collections
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
BACKWARD = "autograd::engine::evaluate_function"
SECTIONS = tuple(f"uncrtaints.{n}" for n in ("cast", "encoder", "ltae", "aggregate", "decoder",
                                             "loss", "optimizer"))


class Ranges:
    """Profiler ranges opened and closed by hooks (a stack per thread is not
    needed: the forward runs on the calling thread, in order)."""

    def __init__(self):
        self.open = []

    def enter(self, name):
        r = torch.profiler.record_function(name)
        r.__enter__()
        self.open.append(r)

    def exit(self):
        self.open.pop().__exit__(None, None, None)

    def wrap(self, name, fn, when=lambda *a, **k: True):
        def run(*args, **kwargs):
            if not when(*args, **kwargs):
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run


def install(model, ranges):
    """The hooks and wrappers on the package under test; returns the module
    labels."""
    from uncrtaints_tpu_torch.models import blocks, layers

    def hook(label):
        return (lambda m, args: ranges.enter(label(m)), lambda m, args, out: ranges.exit())

    for m in model.modules():
        if isinstance(m, layers.Norm2d) and m.norm != "none":
            pre, post = hook(lambda m: f"Norm2d {m.norm}")
        elif isinstance(m, blocks.SE):
            pre, post = hook(lambda m: "SE")
        elif isinstance(m, torch.nn.ReLU):
            pre, post = hook(lambda m: "ReLU")
        else:
            continue
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)
    over_map = lambda x, *a, **k: x.dim() >= 4
    blocks.gelu = ranges.wrap("GELU", blocks.gelu, over_map)
    layers.gelu = ranges.wrap("GELU", layers.gelu, over_map)
    return ["Norm2d batch", "Norm2d group", "Norm2d instance", "GELU", "ReLU", "SE"]


def attribute(prof, labels, kind_table):
    """{part: {"fwd": [ms, n], "bwd": [ms, n], "kinds": {kind: ms}}} and the
    device-busy ms and kernels of the profiled step."""
    label_set = set(labels)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def part(chain):
        section = next((a.name.split(".", 1)[1] for a in chain if a.name in SECTIONS), None)
        module = next((a.name for a in chain if a.name in label_set), None)
        return " / ".join(x for x in (section, module) if x) or "rest"

    seq_label = {}
    for e in events:
        chain = list(ancestors(e))
        if e.sequence_nr >= 0 and not any(a.name.startswith(BACKWARD) for a in chain):
            lab = part(chain)
            if lab != "rest":
                seq_label.setdefault(e.sequence_nr, lab)
    parts = collections.defaultdict(lambda: {"fwd": [0.0, 0], "bwd": [0.0, 0],
                                             "kinds": collections.Counter()})
    busy, n_all = 0.0, 0
    for e in events:
        if not e.kernels:
            continue
        chain = list(ancestors(e))
        node = next((a for a in chain if a.name.startswith(BACKWARD)), None)
        if node is not None:
            lab, way = seq_label.get(node.sequence_nr, "rest"), "bwd"
        else:
            lab, way = part(chain), "fwd"
        for k in e.kernels:
            ms = k.duration / 1e3
            kind = next((name for name, frags in kind_table if any(f in k.name for f in frags)),
                        "other")
            parts[lab][way][0] += ms
            parts[lab][way][1] += 1
            parts[lab]["kinds"][kind] += ms
            busy, n_all = busy + ms, n_all + 1
    return parts, busy, n_all


def report(title, parts, busy, n_all, host_ms):
    print(f"{title}: {host_ms:.1f} ms on the host under the profiler; device busy {busy:.2f} ms "
          f"in {n_all} kernels")
    print("  part: device ms (share), launches; forward ms / launches, backward ms / launches; "
          "ms by kind")
    order = sorted(parts.items(), key=lambda kv: -(kv[1]["fwd"][0] + kv[1]["bwd"][0]))
    for lab, p in order:
        ms = p["fwd"][0] + p["bwd"][0]
        n = p["fwd"][1] + p["bwd"][1]
        kinds = ", ".join(f"{k} {v:.2f}" for k, v in p["kinds"].most_common(4))
        print(f"  {lab}: {ms:.3f} ms ({ms / busy:.1%}), {n}; fwd {p['fwd'][0]:.3f} / "
              f"{p['fwd'][1]}, bwd {p['bwd'][0]:.3f} / {p['bwd'][1]}; {kinds}")


def main():
    if not torch.cuda.is_available():
        print("profile_train_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() if "--root" in args else HERE
    sys.path.insert(0, str(root))  # the package under test
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from torch.profiler import ProfilerActivity, profile

    import uncrtaints_tpu_torch
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state, make_eval_step,
                                            make_train_step)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; package {Path(uncrtaints_tpu_torch.__file__).parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = derive(Config(use_sar=True, scale_by=10.0))
    B, T, P = smoke.B, smoke.T, smoke.PATCH
    ds = SyntheticSEN12MSCRTS(n_samples=B, n_input_t=T, patch_size=P, seed=smoke.SEED + 1)
    batch = batch_to_device(collate_multi([ds[j] for j in range(B)], use_sar=True), dev)
    model = smoke.seeded_model(cfg, dev)
    ranges = Ranges()
    labels = install(model, ranges)
    state, step = create_train_state(cfg, model), make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 4)
    for _ in range(2):  # warm-up
        state, _ = step(state, batch, gen)
        eval_step(model, batch)
    torch.cuda.synchronize()
    for title, run in (("train step", lambda: step(state, batch, gen)),
                       ("eval step", lambda: eval_step(model, batch))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        parts, busy, n_all = attribute(prof, labels, smoke.KERNEL_KINDS)
        report(title, parts, busy, n_all, host_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
