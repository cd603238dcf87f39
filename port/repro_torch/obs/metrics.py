"""Process-local metrics: counters, gauges, timing histograms, the
planner's predicted-against-measured table and a bounded log of finished
spans and counter bumps, with a JSONL event sink.

The registry is plain Python behind a lock: a dict write per event, cheap
enough for eager hot paths. Aggregation is pull-based (``summary()``,
``spans()``, ``counter_log()``); the experiment harness, ``chip_smoke.py``'s
planner phase and the benchmark's per-layer readers are its consumers.

Nothing here waits for a device while an event is recorded. A span's
device interval is a pair of CUDA timing events, resolved, waiting for
them, in ``summary()`` and ``spans()``; a counter bumped by a 0-d device tensor holds the tensor and
folds it into the count in ``summary()`` and ``counter_log()``. Those
three are the only calls that wait.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from array import array
from typing import Any, Dict, List, Optional

# per-timing reservoir: enough for stable p50/p95 at sweep-grade event rates
# without unbounded growth on long runs
_MAX_SAMPLES = 512
# entries the span log and the counter log each keep; later ones are
# counted as dropped
MAX_LOG = 1 << 20


def _jsonable(v: Any) -> Any:
    """Coerce annotation values to JSON-able scalars (0-d tensors, numpy
    scalars and the like become plain float/int/str)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)     # numpy/torch 0-d arrays and scalars
    if callable(item):
        try:
            got = item()
            if isinstance(got, (bool, int, float, str)):
                return got
        except (TypeError, ValueError, RuntimeError):
            pass
    for cast in (int, float):
        try:
            return cast(v)
        except (TypeError, ValueError, RuntimeError):
            continue
    return str(v)


class Timing:
    """Streaming timing histogram: exact count/total/min/max plus a fixed
    reservoir of samples for quantiles (deterministic ring replacement)."""

    __slots__ = ("count", "total", "min", "max", "samples", "device_count",
                 "device_total")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self.samples: List[float] = []
        # device seconds of the spans timed on the device (``device=True``)
        self.device_count = 0
        self.device_total = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds
        samples = self.samples
        if len(samples) < _MAX_SAMPLES:
            samples.append(seconds)
        else:
            samples[self.count % _MAX_SAMPLES] = seconds

    def observe_device(self, seconds: float) -> None:
        self.device_count += 1
        self.device_total += seconds

    def quantile(self, q: float) -> float:
        if not self.samples:
            return float("nan")
        s = sorted(self.samples)
        return s[min(int(q * len(s)), len(s) - 1)]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "total_s": self.total,
                "mean_s": self.total / max(self.count, 1),
                "min_s": self.min if self.count else float("nan"),
                "max_s": self.max,
                "p50_s": self.quantile(0.50), "p95_s": self.quantile(0.95),
                "device_count": self.device_count,
                "device_total_s": self.device_total,
                "device_mean_s": (self.device_total / self.device_count
                                  if self.device_count else float("nan"))}


class SpanEntry:
    """One finished span of the log, as ``MetricsRegistry.spans`` returns
    it: its name and path, its host interval on the profiler's clock
    (Unix-epoch ns), its device seconds (None for a span not timed on the
    device) and its attributes."""

    __slots__ = ("name", "path", "start_ns", "end_ns", "device_s", "attrs")

    def __init__(self, name: str, path: str, start_ns: int, end_ns: int,
                 device_s: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.path = path
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.device_s = device_s
        self.attrs = attrs or {}


@dataclasses.dataclass
class PlanRecord:
    """One (expression, path, distribution) cell of the predicted-against-
    measured table: the §5.3 cost-model prediction frozen at first
    execution, with a timing histogram of every measured eager run of that
    plan."""
    kind: str
    path: str
    expr: str
    predicted: Dict[str, float]          # flops / mem / comm / seconds
    measured: Timing = dataclasses.field(default_factory=Timing)

    def summary(self) -> Dict[str, Any]:
        meas = self.measured.summary()
        pred_s = self.predicted.get("seconds", 0.0)
        # >1: the cost model was optimistic by that factor; the rates only
        # matter up to ranking, so what the table checks is that the ratio
        # is stable across the paths of one family
        ratio = (meas["mean_s"] / pred_s) if pred_s > 0 else float("nan")
        return {"kind": self.kind, "path": self.path, "expr": self.expr,
                "predicted": dict(self.predicted), "measured": meas,
                "measured_over_predicted": ratio}


class MetricsRegistry:
    """Counters + gauges + named timing histograms + plan table + the span
    and counter logs.

    The logs are kept as columns (lists of names and attributes, arrays of
    numbers) rather than an object a span: a traced window logs tens of
    thousands of spans, and an object each would grow the heap that
    Python's garbage collector walks on every full collection."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, Timing] = {}
        self.plans: Dict[str, PlanRecord] = {}
        self.dropped = 0                 # log entries past MAX_LOG
        self._new_logs()
        # (row, path, start event, end event) of device spans not yet
        # resolved
        self._pending_spans: List[tuple] = []
        # (name, 0-d device tensor, row or -1) of counts not yet folded
        self._pending_counts: List[tuple] = []

    def _new_logs(self) -> None:
        # span log: name, path, host start and end (ns), device seconds
        # (nan until resolved; nan for a host span), attributes
        self._spans = ([], [], array("q"), array("q"), array("d"), [])
        # counter log: name, time (ns), value (nan until a held device
        # count is folded)
        self._counts = ([], array("q"), array("d"))

    def counter_add(self, name: str, value: Any = 1.0,
                    t_ns: Optional[int] = None) -> None:
        """Add ``value`` to counter ``name``: a number, or a 0-d tensor,
        which is held (no copy) and folded in when the counters are read.
        ``t_ns`` (the profiler's clock) also logs the bump."""
        device = getattr(value, "device", None)
        held = device is not None and device.type != "cpu"
        with self._lock:
            row = -1
            if t_ns is not None:
                names, times, values = self._counts
                if len(names) < MAX_LOG:
                    row = len(names)
                    names.append(name)
                    times.append(t_ns)
                    values.append(math.nan if held else float(value))
                else:
                    self.dropped += 1
            if held:
                self._pending_counts.append((name, value, row))
                self.counters.setdefault(name, 0.0)
            else:
                self.counters[name] = self.counters.get(name, 0.0) + \
                    float(value)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self.timings.get(name)
            if t is None:
                t = self.timings[name] = Timing()
            t.observe(seconds)

    def record_span(self, name: str, path: str, start_ns: int, end_ns: int,
                    device_s: Optional[float] = None,
                    attrs: Optional[Dict[str, Any]] = None,
                    events=None) -> None:
        """Log a finished span and feed its timing; ``events`` (start, end)
        time it on the device when the log is next read."""
        with self._lock:
            t = self.timings.get(path)
            if t is None:
                t = self.timings[path] = Timing()
            t.observe((end_ns - start_ns) / 1e9)
            if device_s is not None:
                t.observe_device(device_s)
            cols = self._spans
            row = len(cols[0])
            if row < MAX_LOG:
                cols[0].append(name)
                cols[1].append(path)
                cols[2].append(start_ns)
                cols[3].append(end_ns)
                cols[4].append(math.nan if device_s is None else device_s)
                cols[5].append(attrs)
            else:
                self.dropped += 1
                row = -1
            if events is not None:
                if len(self._pending_spans) < MAX_LOG:
                    self._pending_spans.append((row, path) + tuple(events))
                else:
                    self.dropped += 1

    def _resolve(self) -> None:
        """Device seconds of the pending spans, waiting for their end
        events; the lock is held."""
        for row, path, start, end in self._pending_spans:
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
            if row >= 0:
                self._spans[4][row] = seconds
            t = self.timings.get(path)
            if t is not None:
                t.observe_device(seconds)
        self._pending_spans.clear()

    def _fold(self) -> None:
        """Fold the held device counts into the counters; the lock is
        held."""
        for name, value, row in self._pending_counts:
            v = float(value.item())
            self.counters[name] = self.counters.get(name, 0.0) + v
            if row >= 0:
                self._counts[2][row] = v
        self._pending_counts.clear()

    def spans(self, prefix: str = "") -> List[SpanEntry]:
        """The logged spans whose name starts with ``prefix``, in the order
        they finished, their device times resolved (this waits for the
        device)."""
        with self._lock:
            self._resolve()
            names, paths, starts, ends, devs, attrs = self._spans
            return [SpanEntry(n, paths[i], starts[i], ends[i],
                              None if math.isnan(devs[i]) else devs[i],
                              attrs[i])
                    for i, n in enumerate(names) if n.startswith(prefix)]

    def counter_log(self, prefix: str = "") -> List[tuple]:
        """``(name, t_ns, value)`` of each logged counter bump whose name
        starts with ``prefix`` (this waits for held device counts)."""
        with self._lock:
            self._fold()
            names, times, values = self._counts
            return [(n, times[i], values[i]) for i, n in enumerate(names)
                    if n.startswith(prefix)]

    def record_plan(self, key: str, kind: str, path: str, expr: str,
                    predicted: Dict[str, float], seconds: float) -> None:
        """One measured eager execution of a planned contraction; the
        prediction is frozen on first sight of the key (it is a function of
        the static signature alone, so later calls agree)."""
        with self._lock:
            rec = self.plans.get(key)
            if rec is None:
                rec = self.plans[key] = PlanRecord(
                    kind, path, expr, {k: float(v)
                                       for k, v in predicted.items()})
            rec.measured.observe(seconds)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()
            self.plans.clear()
            self._new_logs()
            self.dropped = 0
            self._pending_spans.clear()
            self._pending_counts.clear()

    def summary(self) -> Dict[str, Any]:
        """Counters, gauges, timings (host and device) and the plan table;
        waits for the device work the pending spans and counts cover."""
        with self._lock:
            self._resolve()
            self._fold()
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": {k: t.summary() for k, t in self.timings.items()},
                "plans": {k: r.summary() for k, r in self.plans.items()},
            }


class JsonlSink:
    """Append-only JSONL event stream (one dict per line)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def emit(self, record: Dict[str, Any]) -> None:
        line = json.dumps(_jsonable(record), sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Round-trip reader for JsonlSink files (skips blank lines)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
