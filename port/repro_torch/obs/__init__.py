"""Observability: spans, counters, gauges, a JSONL event sink and kernel
roofline profiling (``profile_fn``, ``Machine``).

Disabled by default: every instrumentation point routes through
:func:`span` / :func:`counter_add` / :func:`gauge_set`, which do nothing
until :func:`enable` is called (or ``REPRO_TRACE=1`` is set), and spans do
nothing while the current CUDA stream captures a graph.

    from repro_torch import obs
    obs.enable(jsonl="trace.jsonl")
    ...                                  # ingest, loop, planner spans
    print(obs.get_registry().summary())  # counters, timings, plan table
"""
from repro_torch.obs.metrics import (JsonlSink, MetricsRegistry, PlanRecord,
                                     Timing, read_jsonl)
from repro_torch.obs.profile import Machine, profile_fn
from repro_torch.obs.trace import (capturing, counter_add, disable,
                                   emit_event, enable, enabled, gauge_set,
                                   get_registry, last_root, sink, span,
                                   synchronize, trace_clean)

__all__ = [
    "span", "enable", "disable", "enabled", "get_registry", "last_root",
    "sink", "emit_event", "counter_add", "gauge_set", "capturing",
    "trace_clean", "synchronize", "MetricsRegistry", "Timing", "PlanRecord",
    "JsonlSink", "read_jsonl", "Machine", "profile_fn",
]
