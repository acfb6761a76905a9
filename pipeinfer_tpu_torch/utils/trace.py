"""Spans, request stamps and CUDA-event device spans inside the serving
engine, kept in memory for a benchmark to read.

Off by default: tracing is on only between ``enable()`` and ``disable()``.
Every site tests the module switch first,

    with trace.span("lanes.admit") if trace.on else trace.OFF:

so while it is off a site reads no clock, allocates nothing and creates
no CUDA event. While it is on:

- a span is ``(name, t0_ns, t1_ns, span_id, parent_id, rid, args)`` on
  ``time.perf_counter_ns``; ``parent_id`` is the span open on the same
  thread when it started (0: none), ``rid`` the serving request that
  caused it (-1: none or several), ``args`` a small tuple of (key, value)
  pairs. The buffer holds CAP spans and drops the oldest, counting them
  in ``spans_dropped``.
- a request stamp is ``stamps[rid][name] = ns`` (submit, admit); stamps
  of CAP requests are kept.
- a device span is a pair of timing events recorded on the current
  stream around launches (``dev``), kept pending in the session until
  ``resolve_ready`` (called after the work's own completion event has
  completed) or ``disable`` reads it. Its times go on the perf_counter
  clock through two anchors, an event recorded and synchronized beside a
  clock reading at ``enable`` and again at ``disable``; the drift between
  the two clocks is spread linearly over the interval.

What the tracer may call, so that it adds nothing to a profiler that
another thread starts and stops: no ``torch.profiler``,
``record_function``, NVTX, kineto or CUPTI call (the profiler belongs to
the caller); the timing events come from a pool that ``enable`` creates
and records once on its own thread, and are reused, never created or
destroyed on the engine thread; an event's time is read only after
``query()`` says it has completed, so the tracer never waits on one. (A CUDA trace stopped while the engine
serves has faulted inside libcupti's own thread with the tracer off too.)
An error inside the tracer is counted in ``errors`` and never reaches the
engine; an empty pool skips the device span and counts it in
``device_spans_skipped``. Spans are appended by the thread that runs
them; read ``snapshot()`` after the traced threads have stopped.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

CAP = 1 << 20  # spans kept; the oldest are dropped beyond it
POOL = 512  # timing events: two per device span in flight

on = False  # the switch every site tests
clock = time.perf_counter_ns
_st = None  # the _State of the current or last session


class _State:
    """One enable() ... disable() session."""

    def __init__(self, device):
        self.spans = collections.deque(maxlen=CAP)
        self.device_spans = []  # (name, t0 ms after anchor 0, t1 ms, span_id)
        self.pending = []  # recorded device spans not read yet
        self.stamps = {}
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.counters = dict(spans_dropped=0, stamps_dropped=0, device_spans_skipped=0,
                             errors=0)
        self.pool = []
        self.anchor0 = self.anchor1 = None  # (event, clock ns)
        self.device = device

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, rec: tuple) -> None:
        if len(self.spans) == CAP:
            self.counters["spans_dropped"] += 1
        self.spans.append(rec)


def _error() -> None:
    try:
        _st.counters["errors"] += 1
    except Exception:  # a tracer fault never reaches the engine
        pass


class _Off:
    """The shared stand-in of every site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, rid=None, args=None) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("st", "name", "rid", "args", "t0", "sid", "parent")

    def __init__(self, st: _State, name: str, rid: int, args: tuple):
        self.st, self.name, self.rid, self.args = st, name, rid, args

    def note(self, rid=None, args=None) -> None:
        """Set the request or the args once they are known."""
        if rid is not None:
            self.rid = rid
        if args is not None:
            self.args = args

    def __enter__(self):
        try:
            stack = self.st.stack()
            self.parent = stack[-1].sid if stack else 0
            self.sid = next(self.st.ids)
            stack.append(self)
            self.t0 = clock()
        except Exception:
            _error()
        return self

    def __exit__(self, *exc):
        try:
            t1 = clock()
            stack = self.st.stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            self.st.add((self.name, self.t0, t1, self.sid, self.parent, self.rid, self.args))
        except Exception:
            _error()
        return False


def span(name: str, rid: int = -1, args: tuple = ()):
    """A host span (a context manager); call only while ``on``."""
    st = _st
    return _Span(st, name, rid, args) if st is not None else OFF


class _Dev:
    """A device span being recorded: two pooled events around launches."""

    __slots__ = ("st", "name", "ev", "sid")

    def __init__(self, st: _State, name: str):
        self.st, self.name, self.ev = st, name, None

    def __enter__(self):
        try:
            if self.st.anchor0 is None:
                return self  # a session without a CUDA device
            if len(self.st.pool) < 2:
                self.st.counters["device_spans_skipped"] += 1
                return self
            stack = self.st.stack()
            self.sid = stack[-1].sid if stack else 0
            self.ev = (self.st.pool.pop(), self.st.pool.pop())
            self.ev[0].record()
        except Exception:
            _error()
            self.ev = None
        return self

    def __exit__(self, *exc):
        try:
            if self.ev is not None:
                self.ev[1].record()
                self.st.pending.append(self)
        except Exception:
            _error()
        return False


def dev(name: str):
    """A device span around the launches inside the ``with`` (a context
    manager; call only while ``on``). The recorded pair stays pending
    until ``resolve_ready`` or ``disable`` reads it. Without a pool (a
    CPU session) nothing is recorded."""
    st = _st
    return _Dev(st, name) if st is not None else OFF


def resolve_ready() -> None:
    """Turn the pending device spans whose end event has completed into
    times and give their events back to the pool; the rest stay pending.
    Never waits. Call it on the thread that records them, after a fetch
    that has waited for their work."""
    st = _st
    if st is None or not st.pending:
        return
    left = []
    for m in st.pending:
        try:
            e0, e1 = m.ev
            if not e1.query():
                left.append(m)
                continue
            a = st.anchor0[0]
            st.device_spans.append((m.name, a.elapsed_time(e0), a.elapsed_time(e1), m.sid))
        except Exception:
            _error()
        st.pool.extend(m.ev)
    st.pending = left


def stamp(rid: int, name: str, t_ns: int | None = None) -> None:
    """Stamp request `rid`'s event `name` at `t_ns` (default: now); call
    only while ``on``. Stamps of CAP requests are kept; the oldest
    request's go first."""
    try:
        st = _st
        if rid not in st.stamps and len(st.stamps) >= CAP:
            del st.stamps[next(iter(st.stamps))]
            st.counters["stamps_dropped"] += 1
        st.stamps.setdefault(rid, {})[name] = clock() if t_ns is None else t_ns
    except Exception:
        _error()


def _anchor(device):
    import torch

    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    return ev, clock()


def enable(device=None) -> None:
    """Start a session; with a CUDA `device`, also the event pool and the
    first anchor (on this thread, with the device idle)."""
    global _st, on
    st = _State(device)
    if device is not None:
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                st.pool = [torch.cuda.Event(enable_timing=True) for _ in range(POOL)]
                for ev in st.pool:  # CUDA makes each event at its first record
                    ev.record()
                st.anchor0 = _anchor(device)
            st.device = device
    _st = st
    on = True


def disable() -> None:
    """End the session: later spans are not kept; the second anchor is
    taken (after the device has drained) so that snapshot() can place
    the device spans, and the pending ones, complete by then, are read.
    Call it after the traced threads have stopped."""
    global on
    on = False
    st = _st
    if st is not None and st.anchor0 is not None and st.anchor1 is None:
        import torch

        with torch.cuda.device(st.device):
            st.anchor1 = _anchor(st.device)
    resolve_ready()


def snapshot() -> dict:
    """A copy of the session: spans, device spans (name, t0_ns, t1_ns,
    span_id) on the perf_counter clock, request stamps, counters, and the
    anchors (host ns at each, the device's ns between them, the drift)."""
    st = _st
    if st is None:
        return dict(spans=[], device_spans=[], stamps={}, counters={}, anchors=None)
    anchors, place = None, None
    if st.anchor0 is not None:
        h0 = st.anchor0[1]
        scale = 1.0
        if st.anchor1 is not None:
            dev_ns = 1e6 * st.anchor0[0].elapsed_time(st.anchor1[0])
            host_ns = st.anchor1[1] - h0
            scale = host_ns / dev_ns if dev_ns > 0 else 1.0
            anchors = dict(h0_ns=h0, h1_ns=st.anchor1[1], device_ns=dev_ns,
                           drift_ns=host_ns - dev_ns)
        else:
            anchors = dict(h0_ns=h0, h1_ns=None, device_ns=None, drift_ns=None)

        def place(ms: float) -> int:
            return h0 + round(1e6 * ms * scale)

    dev_spans = [(n, place(a), place(b), sid) for n, a, b, sid in st.device_spans] \
        if place is not None else []
    return dict(spans=list(st.spans), device_spans=dev_spans,
                stamps={r: dict(s) for r, s in st.stamps.items()},
                counters=dict(st.counters), anchors=anchors)
