"""Observability: spans, counters, gauges and a JSONL event sink.

Disabled by default: every instrumentation point routes through
:func:`span` / :func:`counter_add` / :func:`gauge_set`, which do nothing
until :func:`enable` is called (or ``REPRO_TRACE=1`` is set), and spans do
nothing while the current CUDA stream captures a graph.

    from repro_torch import obs
    obs.enable(jsonl="trace.jsonl")
    ...                                  # ingest and loop spans record
    print(obs.get_registry().summary())  # counters, gauges, timings
"""
from repro_torch.obs.metrics import (JsonlSink, MetricsRegistry, Timing,
                                     read_jsonl)
from repro_torch.obs.trace import (capturing, counter_add, disable,
                                   emit_event, enable, enabled, gauge_set,
                                   get_registry, span, synchronize)

__all__ = [
    "span", "enable", "disable", "enabled", "get_registry", "emit_event",
    "counter_add", "gauge_set", "capturing", "synchronize",
    "MetricsRegistry", "Timing", "JsonlSink", "read_jsonl",
]
