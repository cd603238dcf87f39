"""Low-overhead tracing spans on the profiler's clock.

Tracing is live (:func:`live`) while :func:`enable` has been called (or
``REPRO_TRACE=1`` is set) or while a torch profiler records
(``torch.autograd._profiler_enabled()``), so a profiled window gets the
program's spans and counters with nothing switched on by hand. Off, a span
costs one check of that flag and yields a shared no-op span; live, a span
inside ``torch.cuda.graph`` capture is a no-op too, so it adds no host work
to the capture.

Live spans nest through a thread-local stack: each finished span folds its
record into its parent, and its ``record`` holds its tree, which the
experiment harness attaches to its per-sweep metric history. A span's path
is its parent's path joined to its name by ``/``, unless the name already
extends the parent's path, which keeps a name such as
``serve/fold_in/pack`` whole under ``serve/fold_in``.

Timing never waits for the device. A span stamps its host interval on the
profiler's host clock (:func:`now_ns`: Unix-epoch nanoseconds, the clock
the profiler stamps its host events on), which lines it up with the
device trace's events: its start is read from that clock, its end is the
start plus the monotonic clock's duration. A span opened with
``device=True`` also records a pair of CUDA timing events on the current
stream at enter and exit; the registry resolves them into device seconds
at ``summary()``/``spans()``, the only places that wait (on the CPU the
device interval is the host interval). Every finished span feeds the registry's timing histogram
under its path and its log of spans (``get_registry().spans(prefix)``),
and, when a JSONL sink is installed, emits one flat event line.

Deliberate synchronisations are few and sit behind an explicit request:
the planner's predicted-against-measured table (``planner.dispatch``
``execute``) and the JSONL sink need :func:`enable` (:func:`enabled`; a
profiler alone never turns them on), and the tile tuner's ``fenced_time``
runs only when tuning is asked for.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.obs.metrics import JsonlSink, MetricsRegistry, _jsonable

_REGISTRY = MetricsRegistry()
_SINK: Optional[JsonlSink] = None
_ENABLED = os.environ.get("REPRO_TRACE", "0") == "1"


class _Local(threading.local):
    """Per-thread span stack and the last finished root span."""

    def __init__(self):
        self.stack: list = []
        self.last_root: Optional[Dict[str, Any]] = None


_TLS = _Local()
_profiling = torch.autograd._profiler_enabled
_PLAIN = (int, float, str, bool, type(None))
# the profiler stamps host events in Unix-epoch ns (CLOCK_REALTIME)
now_ns = time.time_ns


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    """True once :func:`enable` was called (or ``REPRO_TRACE=1``): what
    the sink and the fenced planner table wait for."""
    return _ENABLED


def live() -> bool:
    """True while spans and counters record: tracing enabled, or a torch
    profiler recording."""
    return _ENABLED or _profiling()


def enable(jsonl: Optional[str] = None) -> None:
    """Turn tracing on process-wide; ``jsonl`` installs an event sink."""
    global _ENABLED, _SINK
    if jsonl is not None:
        if _SINK is not None:
            _SINK.close()
        _SINK = JsonlSink(jsonl)
    _ENABLED = True


def disable() -> None:
    """Turn tracing off and close any installed sink."""
    global _ENABLED, _SINK
    _ENABLED = False
    if _SINK is not None:
        _SINK.close()
        _SINK = None


def sink() -> Optional[JsonlSink]:
    return _SINK


def emit_event(record: Dict[str, Any]) -> None:
    """Write one non-span event (ingest stats, a summary, …) to the sink,
    if one is installed."""
    if _SINK is not None:
        _SINK.emit(record)


def capturing() -> bool:
    """True while the current CUDA stream captures a graph. Without an
    initialised CUDA context nothing can be capturing."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def trace_clean() -> bool:
    """True when no CUDA graph is being captured: the port's counterpart of
    the reference's "not under a jax trace". Work that must not enter a
    graph (planning, fenced timing, accounting) checks it."""
    return not capturing()


def last_root() -> Optional[Dict[str, Any]]:
    """The most recently finished root span's nested record (this
    thread)."""
    return _TLS.last_root


def synchronize(x) -> None:
    """Wait for every CUDA device that holds a tensor of ``x`` (a tensor,
    or lists, tuples and dicts of them)."""
    seen = set()
    todo = [x]
    while todo:
        t = todo.pop()
        if isinstance(t, torch.Tensor):
            if t.device.type == "cuda" and t.device not in seen:
                seen.add(t.device)
                torch.cuda.synchronize(t.device)
        elif isinstance(t, dict):
            todo.extend(t.values())
        elif isinstance(t, (list, tuple)):
            todo.extend(t)


class _NoopSpan:
    """Shared no-op span: used when tracing is off or while a graph
    captures."""

    __slots__ = ()
    live = False
    record = None
    children = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def annotate(self, **kv) -> None:
        pass


_NOOP = _NoopSpan()


class Span:
    """A live span (see the module docstring). ``record`` holds the
    finished nested dict after exit."""

    __slots__ = ("name", "path", "attrs", "children", "record", "device",
                 "_t0", "_start_ns", "_events")
    live = True

    def __init__(self, name: str, device: bool, attrs: Dict[str, Any]):
        self.name = name
        self.path = name
        self.attrs = attrs
        self.device = device
        self.children: list = []
        self.record: Optional[Dict[str, Any]] = None
        self._events = None

    def annotate(self, **kv) -> None:
        self.attrs.update(kv)

    def __enter__(self):
        if capturing():
            return _NOOP
        st = _TLS.stack
        if st:
            parent = st[-1].path
            if not self.name.startswith(parent + "/"):
                self.path = parent + "/" + self.name
        st.append(self)
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        st = _TLS.stack
        if not st or st[-1] is not self:        # entered under capture
            return
        events = self._events
        if events is not None:
            events[1].record()
        st.pop()
        if self.attrs:
            self.attrs = {k: v if type(v) in _PLAIN else _jsonable(v)
                          for k, v in self.attrs.items()}
        dur = (t1 - self._t0) / 1e9
        rec: Dict[str, Any] = {"kind": "span", "name": self.name,
                               "path": self.path, "dur_s": dur,
                               "start_ns": self._start_ns,
                               "end_ns": self._start_ns + t1 - self._t0}
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.children:
            rec["children"] = self.children
        self.record = rec
        _REGISTRY.record_span(
            self.name, self.path, rec["start_ns"], rec["end_ns"],
            dur if self.device and events is None else None, self.attrs,
            events)
        if st:
            st[-1].children.append(rec)
        else:
            _TLS.last_root = rec
        if _SINK is not None:
            flat = dict(rec)
            flat.pop("children", None)
            flat["depth"] = len(st) + 1          # 1-based: roots at depth 1
            _SINK.emit(flat)


def span(name: str, device: bool = False, **attrs):
    """Context manager for one traced region (see the module docstring):
    a live :class:`Span` while tracing is live, else the shared no-op.
    ``device=True`` also times the region on the device."""
    if _ENABLED or _profiling():
        return Span(name, device, attrs)
    return _NOOP


def counter_add(name: str, value: Any = 1.0) -> None:
    """Registry counter bump, stamped on the profiler's clock; a 0-d
    device tensor is held and folded in when the counters are read. A
    no-op while tracing is off or a graph captures."""
    if (_ENABLED or _profiling()) and not capturing():
        _REGISTRY.counter_add(name, value, now_ns())


def gauge_set(name: str, value: float) -> None:
    """Registry gauge set; a no-op while tracing is off."""
    if _ENABLED or _profiling():
        _REGISTRY.gauge_set(name, value)
