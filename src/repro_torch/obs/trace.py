"""Span tracing: per-thread ring buffers of Chrome ``trace_event`` events.

The serving tier's questions are latency questions — "where did this
request's 40 ms go?" — and answering them needs spans through the whole
request lifecycle (submit → defer → coalesce → dispatch → device-block →
result-collect), across the threads that carry it.  This module is the
substrate: a global :class:`Tracer` that each thread writes into through
its own bounded ring buffer (no cross-thread contention on the hot path;
the only lock is taken once per thread, at buffer registration), with
four event kinds mapping 1:1 onto Chrome ``trace_event`` phases:

* ``span(name, **args)`` — a ``with``-block duration event (phase ``X``);
  mutate ``sp.args`` inside the block to attach results measured late.
* ``instant(name, **args)`` — a point event (phase ``i``).
* ``event(name, dur_s, ...)`` — a completed span recorded after the fact
  from an explicit duration (phase ``X``), for work measured elsewhere
  (e.g. a worker process that can only ship its wall-time home).
* ``flow_start/step/end(name, fid)`` — flow arrows (phases ``s/t/f``)
  stitching one request's spans across threads; Perfetto draws them as
  arrows from submit to dispatch to collect.

Tracing is **disabled by default** and every call on the disabled path is
a constant-time guard that allocates nothing and reads no clock —
``benchmarks/obs_overhead.py`` measures this and holds it under 3% of a
served request.  Cross-thread context: ``capture_context()`` on the
submitting thread, ``attach_context(ctx)`` on the worker, and every event
the worker emits carries the inherited ambient args (the registry's
background-encode threads do exactly this).

Export lives in :mod:`repro_torch.obs.export`; this module stores raw
``(ph, name, cat, ts_ns, dur_ns, args, flow_id)`` tuples only.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

DEFAULT_MAX_EVENTS = 65536      # per-thread ring size (oldest dropped)


class _DiscardArgs(dict):
    """args sink of the shared no-op span: accepts writes, keeps nothing."""

    def __setitem__(self, key, value):
        pass

    def update(self, *a, **kw):
        pass


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()
    args = _DiscardArgs()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Span:
    """A live duration event; emitted into the buffer at ``__exit__``."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._emit("X", self.name, self.cat, self._t0,
                           t1 - self._t0, self.args or None, None)
        return False


class _ThreadBuffer:
    """One thread's bounded event ring (+ overflow accounting)."""

    __slots__ = ("tid", "thread_name", "events", "appended", "generation")

    def __init__(self, tid: int, thread_name: str, maxlen: int,
                 generation: int):
        self.tid = tid
        self.thread_name = thread_name
        self.events: deque = deque(maxlen=maxlen)
        self.appended = 0           # total ever appended; dropped =
        self.generation = generation  # appended - len(events)

    @property
    def dropped(self) -> int:
        return self.appended - len(self.events)


class Tracer:
    """Process-global event sink; one ring buffer per writing thread."""

    def __init__(self, max_events_per_thread: int = DEFAULT_MAX_EVENTS):
        self.enabled = False
        self.max_events_per_thread = int(max_events_per_thread)
        self._tls = threading.local()
        self._buffers: list[_ThreadBuffer] = []
        self._lock = threading.Lock()
        self._generation = 0        # bumped by clear(): stale tls buffers
        self.epoch_ns = time.perf_counter_ns()   # ts 0 of the export

    # -- lifecycle --------------------------------------------------------
    def enable(self, max_events_per_thread: int | None = None) -> None:
        """Start recording (resets nothing; call :meth:`clear` for that)."""
        if max_events_per_thread is not None:
            self.max_events_per_thread = int(max_events_per_thread)
        with self._lock:
            if not self._buffers:
                self.epoch_ns = time.perf_counter_ns()
        self.enabled = True

    def disable(self) -> None:
        """Stop recording; buffered events remain exportable."""
        self.enabled = False

    def clear(self) -> None:
        """Drop every buffered event and start a fresh epoch."""
        with self._lock:
            self._generation += 1
            self._buffers = []
            self.epoch_ns = time.perf_counter_ns()

    # -- recording --------------------------------------------------------
    def _buf(self) -> _ThreadBuffer:
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.generation != self._generation:
            t = threading.current_thread()
            with self._lock:
                buf = _ThreadBuffer(t.ident, t.name,
                                    self.max_events_per_thread,
                                    self._generation)
                self._buffers.append(buf)
            self._tls.buf = buf
        return buf

    def _emit(self, ph, name, cat, ts_ns, dur_ns, args, flow_id) -> None:
        if not self.enabled:
            return
        ctx = getattr(self._tls, "ctx", None)
        if ctx:
            args = {**ctx, **args} if args else dict(ctx)
        buf = self._buf()
        buf.events.append((ph, name, cat, ts_ns, dur_ns, args, flow_id))
        buf.appended += 1

    def span(self, name: str, cat: str = "app", **args):
        """``with tracer.span("dispatch", matrix=mid): ...``"""
        if not self.enabled:
            return _NOOP
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "app", **args) -> None:
        if not self.enabled:
            return
        self._emit("i", name, cat, time.perf_counter_ns(), 0,
                   args or None, None)

    def event(self, name: str, dur_s: float, cat: str = "app",
              **args) -> None:
        """Record an already-measured span ending now (e.g. a worker
        process's wall-time, shipped home in its result)."""
        if not self.enabled:
            return
        end = time.perf_counter_ns()
        dur = max(0, int(dur_s * 1e9))
        self._emit("X", name, cat, end - dur, dur, args or None, None)

    def _flow(self, ph, name, fid, args) -> None:
        if not self.enabled:
            return
        self._emit(ph, name, "flow", time.perf_counter_ns(), 0,
                   args or None, int(fid))

    def flow_start(self, name: str, fid: int, **args) -> None:
        self._flow("s", name, fid, args)

    def flow_step(self, name: str, fid: int, **args) -> None:
        self._flow("t", name, fid, args)

    def flow_end(self, name: str, fid: int, **args) -> None:
        self._flow("f", name, fid, args)

    # -- cross-thread context --------------------------------------------
    def capture_context(self) -> dict:
        """Snapshot this thread's ambient args for a worker to inherit."""
        ctx = getattr(self._tls, "ctx", None)
        return dict(ctx) if ctx else {}

    @contextlib.contextmanager
    def attach_context(self, ctx: dict, **extra):
        """Adopt an inherited context (+ extras) as this thread's ambient
        args; every event emitted inside carries them.  Nests: inner
        attaches merge over outer ones and restore on exit."""
        prev = getattr(self._tls, "ctx", None)
        merged = {**(prev or {}), **(ctx or {}), **extra}
        self._tls.ctx = merged
        try:
            yield merged
        finally:
            self._tls.ctx = prev

    # -- introspection ----------------------------------------------------
    def buffers(self) -> list[_ThreadBuffer]:
        """Live buffer list (snapshot under the lock; export reads this)."""
        with self._lock:
            return list(self._buffers)

    def event_count(self) -> int:
        return sum(len(b.events) for b in self.buffers())

    def dropped_count(self) -> int:
        return sum(b.dropped for b in self.buffers())


# The process-global tracer + module-level convenience API --------------------
TRACER = Tracer()

enable = TRACER.enable
disable = TRACER.disable
clear = TRACER.clear
span = TRACER.span
instant = TRACER.instant
event = TRACER.event
flow_start = TRACER.flow_start
flow_step = TRACER.flow_step
flow_end = TRACER.flow_end
capture_context = TRACER.capture_context
attach_context = TRACER.attach_context


def is_enabled() -> bool:
    return TRACER.enabled
