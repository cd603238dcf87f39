"""Process-local metrics: counters, gauges, timing histograms and the
planner's predicted-against-measured table, with a JSONL event sink.

The registry is plain Python behind a lock: a dict write per event, cheap
enough for eager hot paths. Aggregation is pull-based (``summary()``); the
experiment harness and ``chip_smoke.py``'s planner phase are its
consumers.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Any, Dict, List

# per-timing reservoir: enough for stable p50/p95 at sweep-grade event rates
# without unbounded growth on long runs
_MAX_SAMPLES = 512


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

    __slots__ = ("count", "total", "min", "max", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self.samples: List[float] = []

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(seconds)
        else:
            self.samples[self.count % _MAX_SAMPLES] = seconds

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
                "p50_s": self.quantile(0.50), "p95_s": self.quantile(0.95)}


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
    """Counters + gauges + named timing histograms + plan table."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, Timing] = {}
        self.plans: Dict[str, PlanRecord] = {}

    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self.timings.get(name)
            if t is None:
                t = self.timings[name] = Timing()
            t.observe(seconds)

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

    def summary(self) -> Dict[str, Any]:
        with self._lock:
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
