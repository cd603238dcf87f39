"""Low-overhead tracing spans.

``span(name, **attrs)`` yields a live Span when tracing is enabled and the
current CUDA stream is not capturing a graph; otherwise it yields a shared
no-op span. The no-op path records nothing and never synchronises, so a
span inside ``torch.cuda.graph`` capture adds no host work to the capture
(a synchronisation there would fail it). Live spans nest through a
thread-local stack: each finished span folds its record into its parent,
and its ``record`` holds its tree, which the experiment harness attaches
to its per-sweep metric history.

Timing: a live span's duration is host wall time between ``__enter__`` and
``__exit__``. Kernels run asynchronously, so the caller fences the result
(``sp.fence(out)``), which synchronises the devices of its tensors before
the span ends. Every finished span feeds the registry's timing histogram
under its slash-joined path and, when a JSONL sink is installed, emits one
flat event line.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.obs.metrics import JsonlSink, MetricsRegistry, _jsonable

_REGISTRY = MetricsRegistry()
_SINK: Optional[JsonlSink] = None
_ENABLED = os.environ.get("REPRO_TRACE", "0") == "1"
_TLS = threading.local()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


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
    return getattr(_TLS, "last_root", None)


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


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """A live span. ``record`` holds the finished nested dict after exit."""

    __slots__ = ("name", "path", "attrs", "children", "record")
    live = True

    def __init__(self, name: str, path: str, attrs: Dict[str, Any]):
        self.name = name
        self.path = path
        self.attrs = {k: _jsonable(v) for k, v in attrs.items()}
        self.children: list = []
        self.record: Optional[Dict[str, Any]] = None

    def annotate(self, **kv) -> None:
        self.attrs.update({k: _jsonable(v) for k, v in kv.items()})

    def fence(self, x):
        """Synchronise the devices of ``x``'s tensors so the span's duration
        covers the device work that produced them; returns ``x``."""
        synchronize(x)
        return x


class _NoopSpan:
    """Shared no-op span: used when disabled or while a graph captures."""

    __slots__ = ()
    live = False
    record = None
    children: list = []

    def annotate(self, **kv) -> None:
        pass

    def fence(self, x):
        return x


_NOOP = _NoopSpan()


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Any]:
    """Context manager for one traced region (see module docstring)."""
    if not _ENABLED or capturing():
        yield _NOOP
        return
    st = _stack()
    path = (st[-1].path + "/" + name) if st else name
    sp = Span(name, path, attrs)
    st.append(sp)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        rec: Dict[str, Any] = {"kind": "span", "name": sp.name,
                               "path": sp.path, "dur_s": dur}
        if sp.attrs:
            rec["attrs"] = sp.attrs
        if sp.children:
            rec["children"] = sp.children
        sp.record = rec
        _REGISTRY.observe(sp.path, dur)
        if st:
            st[-1].children.append(rec)
        else:
            _TLS.last_root = rec
        if _SINK is not None:
            flat = dict(rec)
            flat.pop("children", None)
            flat["depth"] = len(st) + 1          # 1-based: roots at depth 1
            _SINK.emit(flat)


def counter_add(name: str, value: float = 1.0) -> None:
    """Registry counter bump; no-op while tracing is disabled."""
    if _ENABLED:
        _REGISTRY.counter_add(name, value)


def gauge_set(name: str, value: float) -> None:
    """Registry gauge set; no-op while tracing is disabled."""
    if _ENABLED:
        _REGISTRY.gauge_set(name, value)
