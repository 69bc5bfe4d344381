"""The port's spans and counters.

A span marks one stage of the program: ``with trace.span("runner.forward"):``.
It records only while a ``torch.profiler`` records (the runner's
``--profile``, an operator's own profiler, a benchmark's traced stretch);
otherwise it costs one check of the profiler's flag and does nothing else,
so no switch of the port turns it on. While the profiler records, a span

- enters ``torch.autograd.profiler.record_function(name)``, so the
  profiler's trace shows the span over the operators and kernels it issued;
- keeps ``(start_ns, end_ns, name, parent, unit)`` in memory: times on
  ``time.time_ns``, the clock of the profiler's timestamps; ``parent`` the
  index of the enclosing span of the same thread; ``unit`` the train step or
  predict call the span belongs to, shared by every span inside it;
- on a CUDA device, records a pair of timing events on the current stream,
  resolved only when the records are read (one synchronise on the last
  event), never on a step's path. A span's device milliseconds are the
  stream's time from reaching its start to reaching its end: the device's
  work for the span, plus any time the device waited for the host to issue
  it.

Counters (``trace.count``) are always on: sums by name over the process's
life, under a lock, for work done on any thread (the loader's batches,
waits and decode time); a reader takes the difference of two readings.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16  # spans kept between resets; later ones are counted in ``dropped``


class Record(NamedTuple):
    """One span. ``parent`` indexes the record list (None at the top);
    ``end_ns`` and the times are None while the span is open. Self times
    are the span's own time less its children's; device times are None
    without CUDA events."""

    start_ns: int
    end_ns: int | None
    name: str
    parent: int | None
    unit: int | None
    host_ms: float | None = None
    self_host_ms: float | None = None
    device_ms: float | None = None
    self_device_ms: float | None = None


class _Open:
    """A span as recorded: its fields and its events until resolved."""

    __slots__ = ("start_ns", "end_ns", "name", "parent", "unit", "events", "device_ms")

    def __init__(self, start_ns, name, parent, unit, events):
        self.start_ns, self.end_ns, self.name, self.parent, self.unit = start_ns, None, name, parent, unit
        self.events, self.device_ms = events, None


class Tracer:
    """The process's spans, per-thread stacks of open spans, the end event
    recorded last, and the counters."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: dict = {}
        self.reset()

    def reset(self) -> None:
        """Forget the spans (the counters run on)."""
        with self.lock:
            self.spans, self.dropped, self.last_event = [], 0, None
            self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


TRACER = Tracer()


class span:
    """A context manager that records the stage ``name`` while a
    ``torch.profiler`` records (see the module's docstring). ``unit`` names
    the step or request; a span without one takes its parent's."""

    __slots__ = ("name", "unit", "rec", "rf")

    def __init__(self, name: str, unit: int | None = None):
        self.name, self.unit = name, unit

    def __enter__(self):
        self.rec = None
        if not _profiler._is_profiler_enabled:
            return self
        tr = TRACER
        if len(tr.spans) >= MAX_RECORDS:
            with tr.lock:
                tr.dropped += 1
            return self
        st = tr.stack()
        parent = st[-1] if st else None
        unit = self.unit
        if unit is None and parent is not None:
            unit = tr.spans[parent].unit
        start = time.time_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.rec = _Open(start, self.name, parent, unit, events)
        with tr.lock:
            st.append(len(tr.spans))
            tr.spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec, tr = self.rec, TRACER
        if rec is None:
            return False
        if rec.events is not None:
            rec.events[1].record()
            tr.last_event = rec.events[1]
        self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        st = tr.stack()
        if st and tr.spans[st[-1]] is rec:
            st.pop()
        return False


def count(name: str, amount: float = 1) -> None:
    """Add ``amount`` to the counter ``name`` (always on, any thread)."""
    with TRACER.lock:
        TRACER.counters[name] = TRACER.counters.get(name, 0) + amount


def counters() -> dict:
    """A copy of the counters."""
    with TRACER.lock:
        return dict(TRACER.counters)


def reset() -> None:
    """Forget every span; the counters run on."""
    TRACER.reset()


def records() -> list:
    """The spans as :class:`Record` s in the order they opened, their
    events resolved (one synchronise on the last event recorded)."""
    with TRACER.lock:
        spans = list(TRACER.spans)
    pending = [s for s in spans if s.events is not None and s.end_ns is not None]
    if pending:
        TRACER.last_event.synchronize()
        for s in pending:
            s.device_ms, s.events = s.events[0].elapsed_time(s.events[1]), None
    child_host = [0.0] * len(spans)
    child_device = [0.0] * len(spans)
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            child_host[s.parent] += (s.end_ns - s.start_ns) / 1e6
            if s.device_ms is not None:
                child_device[s.parent] += s.device_ms
    out = []
    for i, s in enumerate(spans):
        host = None if s.end_ns is None else (s.end_ns - s.start_ns) / 1e6
        out.append(Record(s.start_ns, s.end_ns, s.name, s.parent, s.unit, host,
                          None if host is None else host - child_host[i], s.device_ms,
                          None if s.device_ms is None else s.device_ms - child_device[i]))
    return out


def intervals() -> list:
    """``(start_ns, end_ns, name)`` of every closed span."""
    return [(r.start_ns, r.end_ns, r.name) for r in records() if r.end_ns is not None]


def total_ms(names, clock: str = "host") -> float | None:
    """Milliseconds on ``clock`` (``host`` or ``device``) of the closed
    spans named in ``names`` that lie inside no other such span; None where
    there is none, or, on the device's clock, where a span has no events."""
    if clock not in ("host", "device"):
        raise ValueError(f"clock must be host or device, got {clock!r}")
    names = frozenset(names)
    recs = records()
    total, found = 0.0, False
    for r in recs:
        if r.name not in names or r.end_ns is None:
            continue
        p = r.parent
        while p is not None and recs[p].name not in names:
            p = recs[p].parent
        if p is not None:
            continue
        ms = r.host_ms if clock == "host" else r.device_ms
        if ms is None:
            return None
        total, found = total + ms, True
    return total if found else None


def table() -> str:
    """The recorded spans by name, in the order each name first opened:
    calls, host ms inclusive and self, device ms inclusive and self."""
    rows: dict = {}
    for r in records():
        if r.end_ns is None:
            continue
        row = rows.setdefault(r.name, [0, 0.0, 0.0, None, None])
        row[0] += 1
        row[1] += r.host_ms
        row[2] += r.self_host_ms
        if r.device_ms is not None:
            row[3] = (row[3] or 0.0) + r.device_ms
            row[4] = (row[4] or 0.0) + r.self_device_ms
    width = max([len("span")] + [len(n) for n in rows])

    def ms(v):
        return f"{v:12.3f}" if v is not None else f"{'-':>12}"

    lines = [f"{'span':<{width}} {'calls':>6} {'host ms':>12} {'host self':>12} {'device ms':>12} {'device self':>12}"]
    lines += [f"{n:<{width}} {c:>6d} {ms(h)} {ms(hs)} {ms(d)} {ms(ds)}" for n, (c, h, hs, d, ds) in rows.items()]
    return "\n".join(lines)
