"""The PyTorch port's telemetry (``repro_torch.obs``): counters, gauges,
nested spans, the JSONL sink, the disabled and graph-capture no-op paths,
tracing that follows a recording profiler on its clock, device times and
device counts resolved without a synchronisation until the registry is
read, and the spans the restartable loop, the ingest and the experiment
harness record.

Overhead is bounded by what tracing records, counted, not by a wall-clock
ratio (a ratio of wall times is unsteady when other tests share the host):
a traced run records one timing and one sink line per span and nothing
else, and a run with tracing off records nothing."""
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import obs  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.data import streaming  # noqa: E402
from repro_torch.launch import experiment  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.runtime import RestartableLoop  # noqa: E402


@pytest.fixture(autouse=True)
def clean_obs():
    obs.disable()
    obs.get_registry().reset()
    yield
    obs.disable()
    obs.get_registry().reset()


def test_timing_summary_and_bounded_reservoir():
    t = metrics.Timing()
    for i in range(1, 101):
        t.observe(i / 100)
    s = t.summary()
    assert s["count"] == 100 and s["min_s"] == 0.01 and s["max_s"] == 1.0
    assert math.isclose(s["mean_s"], 0.505)
    assert s["p50_s"] == 0.51 and s["p95_s"] == 0.96
    for _ in range(2000):
        t.observe(0.5)
    assert len(t.samples) == metrics._MAX_SAMPLES and t.count == 2100
    assert math.isnan(metrics.Timing().summary()["p50_s"])


def test_counters_gauges_and_nested_spans_to_jsonl(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    obs.enable(jsonl=path)
    obs.counter_add("c")
    obs.counter_add("c", 2.5)
    obs.gauge_set("g", torch.tensor(4.0))
    with obs.span("outer", size=torch.tensor(3)) as outer:
        assert outer.live
        with obs.span("inner", k=1) as inner:
            assert inner.live and inner.path == "outer/inner"
            x = torch.ones(2)
        with obs.span("inner", k=2):
            pass
        outer.annotate(done=True)
    assert torch.equal(x, torch.ones(2))
    obs.emit_event({"kind": "note", "v": 1})
    obs.disable()
    summ = obs.get_registry().summary()
    assert summ["counters"] == {"c": 3.5}
    assert summ["gauges"] == {"g": 4.0}
    assert set(summ["timings"]) == {"outer", "outer/inner"}
    assert summ["timings"]["outer/inner"]["count"] == 2
    root = outer.record
    assert root["attrs"] == {"size": 3, "done": True}
    assert [c["attrs"]["k"] for c in root["children"]] == [1, 2]
    assert root["dur_s"] >= sum(c["dur_s"] for c in root["children"])
    lines = metrics.read_jsonl(path)
    assert [(e.get("path"), e.get("depth")) for e in lines] == [
        ("outer/inner", 2), ("outer/inner", 2), ("outer", 1), (None, None)]
    assert "children" not in lines[2] and lines[3] == {"kind": "note",
                                                       "v": 1}
    # each line's host interval on the profiler's clock, nested in order
    assert all(e["start_ns"] <= e["end_ns"] for e in lines[:3])
    assert lines[2]["start_ns"] <= lines[0]["start_ns"] <= \
        lines[0]["end_ns"] <= lines[1]["start_ns"] <= lines[2]["end_ns"]
    assert [e.path for e in obs.get_registry().spans()] == [
        "outer/inner", "outer/inner", "outer"]


def test_span_exception_still_closes():
    obs.enable()
    with pytest.raises(KeyError):
        with obs.span("boom"):
            raise KeyError("x")
    assert obs.get_registry().summary()["timings"]["boom"]["count"] == 1
    assert trace._TLS.stack == []


def test_disabled_and_capturing_spans_are_noops(monkeypatch):
    assert not obs.live()
    assert obs.span("off", device=True, k=1) is trace._NOOP
    with obs.span("off") as sp:
        assert not sp.live and sp.record is None
    obs.counter_add("c")
    obs.gauge_set("g", 1.0)
    obs.emit_event({"kind": "dropped"})      # no sink installed
    obs.counter_add("d", torch.ones((), dtype=torch.int32))
    reg = obs.get_registry()
    assert reg.summary() == {"counters": {}, "gauges": {}, "timings": {},
                             "plans": {}}
    assert reg.spans() == [] and reg.counter_log() == [] and \
        reg.dropped == 0
    assert not obs.capturing()               # no CUDA graph here
    obs.enable()
    monkeypatch.setattr(trace, "capturing", lambda: True)
    with obs.span("captured") as sp:
        assert not sp.live
    obs.counter_add("c")
    assert reg.summary()["timings"] == {} and reg.summary()["counters"] == {}
    assert reg.spans() == [] and trace._TLS.stack == []


def _loop_run(tmp_path, steps):
    loop = RestartableLoop(str(tmp_path), lambda i, s: s + 1,
                           ckpt_every=1000)
    return loop.run(torch.zeros(2), steps)


def test_tracing_cost_is_one_record_per_span(tmp_path):
    path = str(tmp_path / "t.jsonl")
    _loop_run(tmp_path / "off", 7)
    assert obs.get_registry().summary()["timings"] == {}
    obs.enable(jsonl=path)
    _loop_run(tmp_path / "on", 7)
    obs.disable()
    summ = obs.get_registry().summary()
    assert list(summ["timings"]) == ["loop/step"]
    assert summ["timings"]["loop/step"]["count"] == 7
    assert summ["counters"] == {} and summ["gauges"] == {}
    lines = metrics.read_jsonl(path)
    assert len(lines) == 7
    assert [e["attrs"]["step"] for e in lines] == list(range(7))


def test_ingest_telemetry(tmp_path):
    obs.enable(jsonl=str(tmp_path / "t.jsonl"))
    ing = streaming.StreamingIngest((30, 20, 10), 2,
                                    spool_dir=str(tmp_path / "spool"))
    ing.consume(streaming.function_stream(0, (30, 20, 10), 3000, 1000))
    _, stats = ing.finalize()
    obs.disable()
    summ = obs.get_registry().summary()
    assert summ["counters"]["ingest/spills"] == stats.spills == 6
    assert summ["counters"]["ingest/entries_read"] == 3000
    assert summ["gauges"]["ingest/mnnz_per_s"] == stats.mnnz_per_s > 0
    (event,) = metrics.read_jsonl(str(tmp_path / "t.jsonl"))
    assert event["kind"] == "ingest" and event["nnz"] == stats.nnz


def test_experiment_trace_rides_the_report(tmp_path):
    spec = experiment.ExperimentSpec(
        "tiny-trace", "function", (30, 20, 10), nnz=3000, chunk_size=1000,
        rank=3, sweeps=2)
    report = experiment.run_experiment(
        spec, out_dir=str(tmp_path),
        algorithms=("als",), losses=("quadratic",), trace=True,
        device="cpu")
    assert not obs.enabled()
    timings = report["obs"]["timings"]
    assert timings["loop/step"]["count"] == 2
    assert timings["loop/step/sweep"]["count"] == 2
    for e in report["runs"][0]["sweeps"]:
        assert e["trace"]["name"] == "sweep"
    lines = metrics.read_jsonl(str(tmp_path / "trace_tiny-trace.jsonl"))
    kinds = [e["kind"] for e in lines]
    assert kinds[0] == "ingest" and kinds[-1] == "experiment_summary"
    # loop/step and sweep per sweep; inside each sweep, the planner's span
    # of each of ALS's three right-hand-side MTTKRPs; and each kernel
    # wrapper's span, carrying the tile its launch resolved
    spans = [e for e in lines if e["kind"] == "span"]
    kernel = [e["path"] for e in spans if e["name"].startswith("kernel/")]
    assert {e["attrs"]["tile"] for e in spans
            if e["name"].startswith("kernel/")} == {"br8.t256.p2.f32"}
    spans = [e["path"] for e in spans if not e["name"].startswith("kernel/")]
    # per sweep and mode: ALS's right-hand side (the planner's span of its
    # MTTKRP inside) and its CG
    assert len(spans) == 22
    assert spans.count("loop/step/sweep/als/rhs/planner/mttkrp/"
                       "all_at_once") == 6
    assert spans.count("loop/step/sweep/als/rhs") == 6
    assert spans.count("loop/step/sweep/als/cg") == 6
    assert [p for p in spans if "/als/" not in p] == \
        ["loop/step/sweep", "loop/step"] * 2
    # per sweep: the MTTKRP under each planner span, 1 + cg_iters fused
    # matvecs per mode, and three TTTPs after the sweep (the objective and
    # the train and held-out metrics)
    assert sorted(set(kernel)) == [
        "loop/step/kernel/tttp",
        "loop/step/sweep/als/cg/kernel/cg_matvec_bucketed",
        "loop/step/sweep/als/rhs/planner/mttkrp/all_at_once/kernel/"
        "mttkrp_bucketed"]
    assert kernel.count("loop/step/sweep/als/rhs/planner/mttkrp/all_at_once/"
                        "kernel/mttkrp_bucketed") == 6
    assert kernel.count("loop/step/sweep/als/cg/kernel/"
                        "cg_matvec_bucketed") == 2 * 3 * (1 + spec.cg_iters)
    assert kernel.count("loop/step/kernel/tttp") == 2 * 3
    # each CG counts its budget and the iterations some row was active in;
    # the planner counts a miss per mode's first MTTKRP, then hits
    counters = report["obs"]["counters"]
    assert counters["cg/iterations"] == 2 * 3 * spec.cg_iters
    assert 2 * 3 <= counters["cg/active_iterations"] <= \
        counters["cg/iterations"]
    assert counters["planner/plan_cache/misses"] == 3
    assert counters["planner/plan_cache/hits"] == 3
    # the spans timed on the device (the host's clock on the CPU)
    timings = report["obs"]["timings"]
    assert timings["loop/step/sweep/als/cg"]["device_count"] == 6
    assert timings["loop/step/sweep"]["device_count"] == 0
    # one plan per mode's MTTKRP, measured once per sweep
    plans = report["obs"]["plans"].values()
    assert len(plans) == 3
    assert all(p["path"] == "all_at_once" and p["measured"]["count"] == 2
               for p in plans)


# ---------------------------------------------------------------------------
# tracing under a profiler, its clock, and nothing that waits
# ---------------------------------------------------------------------------

def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def test_live_follows_a_recording_profiler():
    """A recording profiler makes tracing live for exactly its window, and
    turns on neither the sink nor the fenced planner table (``enabled``)."""
    with obs.span("before"):
        pass
    with _cpu_profile():
        assert obs.live() and not obs.enabled()
        with obs.span("inside", device=True) as sp:
            assert sp.live
        obs.counter_add("c", 2)
    assert not obs.live()
    with obs.span("after"):
        pass
    obs.counter_add("c", 5)
    reg = obs.get_registry()
    (e,) = reg.spans()
    assert e.name == "inside" and e.device_s == pytest.approx(
        (e.end_ns - e.start_ns) / 1e9)        # the CPU: the host interval
    assert reg.summary()["counters"] == {"c": 2.0}


def test_span_stamps_lie_on_the_profilers_clock():
    """A span's start and end lie inside a ``record_function`` mark
    entered and left around it: both read the profiler's host clock."""
    from torch.profiler import record_function
    with _cpu_profile():
        with record_function("warm-up"):
            pass
    with _cpu_profile() as prof:
        with record_function("mark"):
            with obs.span("inside"):
                x = sum(range(1000))
    assert x == 499500
    (mark,) = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "mark"]
    (sp,) = obs.get_registry().spans("inside")
    m0, m1 = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    assert m0 <= sp.start_ns < sp.end_ns <= m1
    assert abs(obs.now_ns() - time.time_ns()) < 1_000_000


class _FakeEvent:
    """A CUDA timing event's interface on the CPU: ``synchronize``
    completes it."""

    def __init__(self, ms):
        self.ms, self.done, self.waits = ms, False, 0

    def synchronize(self):
        self.waits += 1
        self.done = True

    def elapsed_time(self, end):
        assert end.done             # the start precedes it on its stream
        return end.ms - self.ms


class _FakeDeviceScalar:
    """A 0-d device tensor's interface: reading it is a wait."""

    device = torch.device("cuda", 0)

    def __init__(self, v):
        self.v, self.reads = v, 0

    def item(self):
        self.reads += 1
        return self.v


def test_device_times_resolve_only_when_read():
    """A device span's time resolves when the registry is read, the only
    place that waits for its end event; recording it waits for nothing."""
    reg = obs.get_registry()
    first = [_FakeEvent(1.0), _FakeEvent(4.0)]
    second = [_FakeEvent(5.0), _FakeEvent(5.5)]
    reg.record_span("a", "a", 10, 20, events=first)
    reg.record_span("b", "b", 30, 40, events=second)
    reg.record_span("c", "c", 50, 60)                     # a host span
    assert first[1].waits == second[1].waits == 0
    assert reg.timings["a"].device_count == 0
    (b,) = reg.spans("b")                                 # waits
    assert first[1].waits == second[1].waits == 1
    assert b.device_s == pytest.approx(5e-4)
    assert (b.start_ns, b.end_ns) == (30, 40)
    assert reg._spans[4][0] == pytest.approx(3e-3)
    t = reg.summary()["timings"]
    assert first[1].waits == 1                            # resolved once
    assert t["a"]["device_count"] == 1 and t["c"]["device_count"] == 0
    assert t["b"]["device_total_s"] == pytest.approx(5e-4)


def test_device_counts_fold_when_the_counters_are_read():
    """A device scalar bumps its counter by reference (no read, no wait)
    and is folded in by ``summary()``; the counter log gets its value."""
    obs.enable()
    v = _FakeDeviceScalar(7)
    obs.counter_add("cg/active_iterations", v)
    obs.counter_add("cg/iterations", 32)
    assert v.reads == 0
    reg = obs.get_registry()
    assert reg.counters["cg/active_iterations"] == 0.0
    summ = reg.summary()
    assert v.reads == 1
    assert summ["counters"] == {"cg/active_iterations": 7.0,
                                "cg/iterations": 32.0}
    log = reg.counter_log("cg/")
    assert [(n, c) for n, _, c in log] == [("cg/active_iterations", 7.0),
                                           ("cg/iterations", 32.0)]
    assert log[0][1] <= log[1][1] <= obs.now_ns()
    reg.summary()
    assert v.reads == 1 and reg.summary()["counters"]["cg/iterations"] == 32.0


def test_logs_are_bounded(monkeypatch):
    monkeypatch.setattr(metrics, "MAX_LOG", 3)
    obs.enable()
    for i in range(5):
        with obs.span("s", i=i):
            pass
        obs.counter_add("c")
    reg = obs.get_registry()
    assert [e.attrs["i"] for e in reg.spans()] == [0, 1, 2]
    assert len(reg.counter_log()) == 3 and reg.dropped == 4
    summ = reg.summary()
    assert summ["counters"]["c"] == 5.0 and summ["timings"]["s"]["count"] == 5


def test_no_span_or_counter_waits_for_the_device(monkeypatch):
    """An ALS sweep, a GGN iteration and a fold-in under a recording
    profiler (tracing live, as in a traced benchmark run): no span or
    counter calls ``torch.cuda.synchronize`` or ``obs.synchronize`` (both
    raise here), and they land in the registry, which ``summary()`` then
    reads."""
    from repro_torch.core.completion import make_step
    from repro_torch.data.pipeline import CompletionDataset
    from repro_torch.launch.complete import rmse
    from repro_torch.serve import ServeEngine, ServingModel
    g = torch.Generator().manual_seed(3)
    shape, nnz, r = (30, 20, 10), 1500, 4
    idx = torch.stack([torch.randint(0, n, (nnz,), generator=g)
                       for n in shape], 1).to(torch.int32)
    st = SparseTensor.from_coo(idx, torch.rand(nnz, generator=g) + 0.5,
                               shape)
    ds = CompletionDataset(st, torch.Generator().manual_seed(4),
                           block_rows=8)
    fs = [torch.randn(n, r, generator=g) / r for n in shape]

    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    eng = ServeEngine(ServingModel([f.clone() for f in fs]), device="cpu")
    hist = [(np.stack([np.arange(5) % 20, np.arange(5) % 10], 1),
             np.ones(5, np.float32)) for _ in range(3)]
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(trace, "synchronize", boom)
    monkeypatch.setattr(obs, "synchronize", boom)
    with _cpu_profile():
        for algo, kw in (("als", {}), ("ggn", {"loss": "poisson_log"})):
            state, step, get = make_step(algo, ds.tensor, ds.omega, fs,
                                         lam=1e-3, block_rows=8, cg_iters=5,
                                         **kw)
            state = step(0, state)
            rmse(ds.tensor, get(state))
        eng.fold_in(hist, 0)
    monkeypatch.undo()
    reg = obs.get_registry()
    names = {e.name for e in reg.spans()}
    assert {"als/rhs", "als/cg", "ggn/curvature", "ggn/gradient", "ggn/pcg",
            "ggn/line_search", "ggn/mode_cg", "ggn/accept", "complete/rmse",
            "serve/fold_in/pack", "serve/fold_in/bucket_pattern",
            "serve/readback", "kernel/cg_matvec_bucketed"} <= names
    counters = reg.summary()["counters"]
    # ALS: three modes of 5; GGN: three damped passes of 5; fold-in: its
    # eager solve (no graph on the CPU) of max(4R, 32)
    assert counters["cg/iterations"] == 3 * 5 + 3 * 5 + 32
    assert 0 < counters["cg/active_iterations"] <= counters["cg/iterations"]
