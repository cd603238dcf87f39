"""Observability: spans, counters, gauges, a JSONL event sink and kernel
roofline profiling (``profile_fn``, ``Machine``).

Off by default: every instrumentation point routes through :func:`span` /
:func:`counter_add` / :func:`gauge_set`, which record only while tracing
is live (:func:`live`): after :func:`enable` (or with ``REPRO_TRACE=1``),
or while a torch profiler records. Spans do nothing while the current CUDA
stream captures a graph, never wait for the device, and stamp their host
interval on the profiler's clock; ``span(name, device=True)`` also times
the region on the device with CUDA events.

    from repro_torch import obs
    obs.enable(jsonl="trace.jsonl")
    ...                                  # ingest, loop, planner spans
    print(obs.get_registry().summary())  # counters, timings, plan table
    obs.get_registry().spans("als/")     # the logged spans, device times
"""
from repro_torch.obs.metrics import (JsonlSink, MetricsRegistry, PlanRecord,
                                     SpanEntry, Timing, read_jsonl)
from repro_torch.obs.profile import Machine, profile_fn
from repro_torch.obs.trace import (capturing, counter_add, disable,
                                   emit_event, enable, enabled, gauge_set,
                                   get_registry, last_root, live, now_ns,
                                   sink, span, synchronize, trace_clean)

__all__ = [
    "span", "enable", "disable", "enabled", "live", "now_ns",
    "get_registry", "last_root", "sink", "emit_event", "counter_add",
    "gauge_set", "capturing", "trace_clean", "synchronize",
    "MetricsRegistry", "Timing", "PlanRecord", "SpanEntry", "JsonlSink",
    "read_jsonl", "Machine", "profile_fn",
]
