"""The traced windows: ``torch.profiler`` over a few requests after the timed
window, reduced to what the per-layer metrics read. Two windows, the same
length, one after the other:

- the device window records the device's activity only (CUPTI; the host
  runs as untraced but for the launch records), so its busy and idle time
  stand for the timed window's: its device operations (kernels, copies,
  fills) with their names and times, the window's length on the host clock
  (first call to the synchronize that ends it), the requests;
- the host window records the host's operators with their input shapes and
  dtypes too (about twice the host's time a request): each call of a
  hand-written kernel's operator (``uncrtaints::...``) with the device time
  of every operation it launched, nested calls included (the roofline
  metrics' input), and what the host was doing in each gap in which the
  device was idle (the breakdown's gaps; their lengths carry the
  profiler's cost).

The benchmark marks the host window with its own spans (``record_function``):
``bench.window`` around it and ``bench.request`` around each request.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

WINDOW, REQUEST = "bench.window", "bench.request"


def _device_us(e) -> float:
    t = getattr(e, "device_time_total", None)
    return float(t if t is not None else e.cuda_time_total)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device_ops(events, w0: float = -float("inf"), w1: float = float("inf")):
    """(name, start, end) in µs of the device's operations within [w0, w1]
    (the benchmark's own spans also show on the device's timeline)."""
    from torch.autograd import DeviceType
    return [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
            if e.device_type == DeviceType.CUDA and e.name not in (WINDOW, REQUEST)
            and e.time_range.end > w0 and e.time_range.start < w1]


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    out, t = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    return out


class Trace:
    """Both windows of ``run(seconds=..., max_requests=..., span=...)``
    reduced (times in seconds)."""

    def __init__(self, run: Callable, op_names):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        run(seconds=0.0, max_requests=1, span=False)  # the profiler's start-up comes first
        ops = []
        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w = run(span=False)
            ops = _device_ops(prof.events())
            del prof
        else:  # nothing runs on a device here: the window alone
            w = run(span=False)
        self.requests, self.window_s = w["requests"], w["t1"] - w["t0"]
        self.device_ops = [(n, a / 1e6, b / 1e6) for n, a, b in ops]
        self.busy_s = sum(b - a for a, b in merge([(a, b) for _, a, b in self.device_ops]))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run(seconds=0.0, max_requests=1, span=False)
            with span(WINDOW):
                run(span=True)
        events = prof.events()
        win = next(e for e in events if e.name == WINDOW)
        w0, w1 = win.time_range.start, win.time_range.end
        busy = merge([(a, b) for _, a, b in _device_ops(events, w0, w1)])
        kineto_dtypes = {}  # by correlation id, where the events lack the dtypes
        if any(e.name in op_names and not getattr(e, "input_dtypes", None) for e in events):
            kineto_dtypes = {k.correlation_id(): list(k.dtypes())
                             for k in prof.profiler.kineto_results.events()
                             if k.device_type() == DeviceType.CPU and k.name() in op_names}
        self.kernel_calls: List[dict] = []
        host = []
        for e in events:
            if e.device_type == DeviceType.CUDA or not (w0 <= e.time_range.start < w1):
                continue
            if e.thread == win.thread:
                host.append((e.name, e.time_range.start, e.time_range.end))
            if e.name in op_names and not _inside_same(e):
                self.kernel_calls.append({
                    "op": e.name, "shapes": [list(s) for s in e.input_shapes],
                    "dtypes": list(getattr(e, "input_dtypes", None)
                                   or kineto_dtypes.get(e.id, [])),
                    "scalars": list(getattr(e, "concrete_inputs", None) or []),
                    "device_s": _device_us(e) / 1e6})
        self.host_gaps = []
        for a, b in gaps(busy, w0, w1):
            mid = (a + b) / 2
            inner = [h for h in host if h[1] <= mid < h[2]]
            name = max(inner, key=lambda h: h[1])[0] if inner else "host"
            self.host_gaps.append(("host (between requests)" if name == WINDOW else name,
                                   (b - a) / 1e6))

    def breakdown(self, fragments: Dict[str, tuple], n: int = 10) -> Dict[str, list]:
        """The device operations that took most time (device window; a
        hand-written kernel's name led by its family, found by the
        ``fragments`` of its name) and the longest idle gaps by what the host
        was doing (host window)."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.device_ops:
            fam = next((f for f, frags in fragments.items() if any(x in name for x in frags)),
                       None)
            name = f"{fam}: {name}" if fam else name
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        longest = sorted(self.host_gaps, key=lambda g: -g[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in longest]}


def _inside_same(e) -> bool:
    """Whether ``e`` runs inside another call of the same operator (the
    dispatcher can record an operator at more than one level)."""
    p = e.cpu_parent
    while p is not None:
        if p.name == e.name:
            return True
        p = p.cpu_parent
    return False


def span(name: str):
    return torch.profiler.record_function(name)
