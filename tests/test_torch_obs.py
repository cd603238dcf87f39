"""The PyTorch port's telemetry (``repro_torch.obs``): counters, gauges,
nested spans, the JSONL sink, the disabled and graph-capture no-op paths,
and the spans the restartable loop, the ingest and the experiment harness
record.

Overhead is bounded by what tracing records, counted, not by a wall-clock
ratio (a ratio of wall times is unsteady when other tests share the host):
a traced run records one timing and one sink line per span and nothing
else, and a run with tracing off records nothing."""
import math
import os
import sys

import pytest
import torch

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import obs  # noqa: E402
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
            x = inner.fence(torch.ones(2))
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


def test_span_exception_still_closes():
    obs.enable()
    with pytest.raises(KeyError):
        with obs.span("boom"):
            raise KeyError("x")
    assert obs.get_registry().summary()["timings"]["boom"]["count"] == 1
    assert trace._stack() == []


def test_disabled_and_capturing_spans_are_noops(monkeypatch):
    with obs.span("off") as sp:
        assert not sp.live and sp.record is None
        x = torch.ones(3)
        assert sp.fence(x) is x
    obs.counter_add("c")
    obs.gauge_set("g", 1.0)
    obs.emit_event({"kind": "dropped"})      # no sink installed
    assert obs.get_registry().summary() == {"counters": {}, "gauges": {},
                                            "timings": {}, "plans": {}}
    assert not obs.capturing()               # no CUDA graph here
    obs.enable()
    monkeypatch.setattr(trace, "capturing", lambda: True)
    with obs.span("captured") as sp:
        assert not sp.live
    assert obs.get_registry().summary()["timings"] == {}


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
    assert len(spans) == 10
    assert spans.count("loop/step/sweep/planner/mttkrp/all_at_once") == 6
    assert [p for p in spans if "planner" not in p] == \
        ["loop/step/sweep", "loop/step"] * 2
    # per sweep: the MTTKRP under each planner span, 1 + cg_iters fused
    # matvecs per mode, and three TTTPs after the sweep (the objective and
    # the train and held-out metrics)
    assert sorted(set(kernel)) == [
        "loop/step/kernel/tttp", "loop/step/sweep/kernel/cg_matvec_bucketed",
        "loop/step/sweep/planner/mttkrp/all_at_once/kernel/mttkrp_bucketed"]
    assert kernel.count("loop/step/sweep/planner/mttkrp/all_at_once/kernel/"
                        "mttkrp_bucketed") == 6
    assert kernel.count("loop/step/sweep/kernel/cg_matvec_bucketed") == \
        2 * 3 * (1 + spec.cg_iters)
    assert kernel.count("loop/step/kernel/tttp") == 2 * 3
    # one plan per mode's MTTKRP, measured once per sweep
    plans = report["obs"]["plans"].values()
    assert len(plans) == 3
    assert all(p["path"] == "all_at_once" and p["measured"]["count"] == 2
               for p in plans)
