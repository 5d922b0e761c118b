"""Spans and counters inside the eval and train steps.

Nothing here records anything unless a ``torch.profiler`` session is
active: a span is then one ``torch.autograd._profiler_enabled()`` check and
an empty context. There is no flag: ``--trace_dir`` (cli/train.py) and any
other profiler around a step turn the spans on.

Under a profiler a span

- emits a profiler range ``uncrtaints.<name>`` that the profiler records as
  an operator event (category ``cpu_op``, on the profiler's clock), not as a
  user annotation, which the profiler would also put on the device's
  timeline as a CUDA-type event;
- on a step that runs on a CUDA device, records a pair of timing events
  (``torch.cuda.Event``) around its work, on the stream that was current
  when the step began;
- appends itself to the open step record: its name, its parent span, its
  start and end on the host clock (``time.perf_counter``), the events.

The outermost spans, ``eval_step`` and ``train_step`` (:func:`step`), open
a step record on their thread with a running index (the request's
identifier) and close it into a buffer of the last ``KEEP`` steps
(:func:`steps`, :func:`take`). Sections sit flat under the step: ``cast``,
``encoder``, ``ltae``, ``aggregate``, ``convlstm``, ``decoder``, ``loss``,
``backward``, ``optimizer``, ``grad_sync``; a span opened inside another (a
block recomputed under ``backward``) names it as its parent, so a section's
self time is its span less the spans it contains. :func:`count` adds bytes to a
counter of the open step record (``cast``: what the dtype conversions and
scale_by multiplies write; ``reflect_pad``: the padded tensors of the eager
reflect pad; ``convlstm``: the [x, h] concatenations and the gates'
pre-activations a ConvLSTM writes each time step; ``norm_onchip``: what the
one-pass norms did not read a second time, x forward, g and x backward;
``gn_chain``: the input of each eval group-norm MBConv that ran as the
kernel chain, ``models/blocks.py:MBConv._fused_group_body``).

The spans leave ``torch.export`` and ``FlopCounterMode`` alone: neither runs
a profiler, so the spans are empty contexts under them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "uncrtaints."
KEEP = 1024  # step records kept

_NULL = contextlib.nullcontext()
_closed: collections.deque = collections.deque(maxlen=KEEP)
_index = itertools.count()
_local = threading.local()  # .record: the open step record; .open: its open spans


class Span:
    """One span of a step record: ``parent`` is the index of the span that
    contains it in ``Step.spans`` (None for the step's own span)."""
    __slots__ = ("name", "parent", "t0", "t1", "events")

    def __init__(self, name: str, parent: Optional[int], events):
        self.name, self.parent, self.events = name, parent, events
        self.t0 = self.t1 = time.perf_counter()

    def device_ms(self) -> Optional[float]:
        """The span's time on the device clock, in ms (None on the CPU).
        Waits for the span's end event."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class Step:
    """One step's record: its running ``index``, its spans in the order they
    opened (``spans[0]`` the step's own), and its counters in bytes. The
    spans' events go on ``stream``, the step's current stream when it
    opened (None on the CPU)."""
    __slots__ = ("index", "stream", "spans", "counters")

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    @property
    def name(self) -> str:
        return self.spans[0].name

    @property
    def t0(self) -> float:
        return self.spans[0].t0


class _Open:
    """The context of one span while a profiler is active."""
    __slots__ = ("name", "device", "range", "span", "opened")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name, self.device = name, device

    def __enter__(self):
        rec = getattr(_local, "record", None)
        self.opened = rec is None and self.device is not None
        if self.opened:
            rec = _local.record = Step(next(_index), self.device)
            _local.open = []
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.span = None
        if rec is not None:
            events = None
            if rec.stream is not None:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(rec.stream)
            stack = _local.open
            self.span = Span(self.name, stack[-1] if stack else None, events)
            stack.append(len(rec.spans))
            rec.spans.append(self.span)
        return self

    def __exit__(self, *exc):
        sp = self.span
        if sp is not None:
            if sp.events is not None:
                sp.events[1].record(_local.record.stream)
            sp.t1 = time.perf_counter()
            _local.open.pop()
        self.range.__exit__(None, None, None)
        if self.opened:
            _closed.append(_local.record)
            _local.record = None
        return False


def span(name: str):
    """The span ``uncrtaints.<name>`` around a section of a step (or, outside
    a step, a profiler range alone)."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Open(name)


def step(name: str, model: torch.nn.Module):
    """The span of a whole step of ``model`` (``eval_step``, ``train_step``):
    it opens the step record, unless one is open on this thread already."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Open(name, next(model.parameters()).device)


def recording() -> bool:
    """Whether a profiler is active and a step record is open on this
    thread (what :func:`count` adds to)."""
    return (torch.autograd._profiler_enabled()
            and getattr(_local, "record", None) is not None)


def open_record() -> Optional[Step]:
    """The open step record of this thread while :func:`recording` (else
    None), for work that runs on another thread: autograd runs a CUDA
    backward on its own, and counts into the record its forward saw."""
    return _local.record if recording() else None


def count(name: str, nbytes: int, record: Optional[Step] = None) -> None:
    """Add ``nbytes`` to counter ``name`` of ``record`` (one
    :func:`open_record` gave), else of this thread's open step record
    (nothing without a profiler or outside a step)."""
    if record is None and recording():
        record = _local.record
    if record is not None:
        record.counters[name] = record.counters.get(name, 0) + int(nbytes)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def steps() -> List[Step]:
    """The closed step records, oldest first (the last ``KEEP``)."""
    return list(_closed)


def take() -> List[Step]:
    """The closed step records, and clear them."""
    out = list(_closed)
    _closed.clear()
    return out
