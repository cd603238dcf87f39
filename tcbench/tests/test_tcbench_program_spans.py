"""The per-layer readers of the program's own spans and counters
(``repro_torch.obs``): on a made-up trace and registry, and in a traced
CPU run of each small cell."""
import json
import types

import pytest
import torch

from tcbench import run, spec
from tcbench.tests.small import CELLS, bench, small
from tcbench.trace import Trace

MS = 1_000_000
NEW = {
    "cg_ms.sweep": ("solvers", "program_span", "sweep_ms"),
    "rmse_ms.sweep": ("drivers", "program_span", "sweep_ms"),
    "cg_active_share.sweep": ("solvers", "program_counter", "sweep_ms"),
    "cg_active_share.foldin": ("serve engine", "program_counter",
                               "users_per_s"),
    "host_prep_idle_ms.serve": ("serve engine", "program_span",
                                "users_per_s"),
    "replay_idle_ms.serve": ("serve engine", "program_span", "users_per_s"),
}


@pytest.fixture
def registry():
    bench()                              # puts the program on the path
    from repro_torch import obs
    obs.disable()
    reg = obs.get_registry()
    reg.reset()
    yield reg
    reg.reset()


def _read(metric, trace, **work):
    view = types.SimpleNamespace(trace=trace, work=work, config={},
                                 traffic={})
    return spec.load_reader(metric).read(view)


def _span(reg, name, a, b, device_s=None):
    reg.record_span(name, "x/" + name, a * MS, b * MS, device_s)


def _trace():
    # the window [100, 200] ms; the device busy over [110, 150] and
    # [170, 180], so idle over [100, 110], [150, 170] and [180, 200]
    device = [("k", 110 * MS, 150 * MS), ("k", 170 * MS, 180 * MS)]
    return Trace(device, [], (100 * MS, 200 * MS))


def test_new_entries_and_their_readers():
    b = spec.load()
    entries = {m["name"]: m for m in b["per_layer"]}
    for name, (layer, source, moves) in NEW.items():
        m = entries[name]
        assert (m["layer"], m["source"], m["moves"]) == (layer, source, moves)
        reader = spec.load_reader(name)
        assert (reader.LAYER, reader.SOURCE, reader.MOVES) == \
            (layer, source, moves)
        for cell in m["workloads"]:
            assert moves in spec.e2e_metrics(b, cell)
    assert list(entries)[-len(NEW):] == list(NEW)


def test_solver_readers_on_a_made_up_registry(registry):
    t = _trace()
    for name in ("cg_ms.sweep", "rmse_ms.sweep", "cg_active_share.sweep"):
        assert _read(name, t, sweeps=2) is None       # nothing logged
    _span(registry, "als/cg", 101, 120, 0.030)
    _span(registry, "ggn/pcg", 120, 130, 0.010)
    _span(registry, "ggn/mode_cg", 130, 140, 0.004)
    _span(registry, "ggn/line_search", 140, 150, 0.5)  # not a CG
    _span(registry, "als/cg", 90, 110, 7.0)            # starts before
    _span(registry, "als/cg", 190, 201, 7.0)           # ends after
    _span(registry, "complete/rmse", 150, 160, 0.002)
    assert _read("cg_ms.sweep", t, sweeps=2) == pytest.approx(22.0)
    assert _read("rmse_ms.sweep", t, sweeps=2) == pytest.approx(1.0)
    assert _read("cg_ms.sweep", t, sweeps=0) is None
    for name, t_ms, v in (("cg/iterations", 105, 20), ("cg/active_iterations",
                          105, 15), ("cg/iterations", 150, 20),
                          ("cg/active_iterations", 150, 3),
                          ("cg/iterations", 99, 20),       # before
                          ("cg/active_iterations", 99, 20),
                          ("other", 150, 9)):
        registry.counter_add(name, v, t_ms * MS)
    assert _read("cg_active_share.sweep", t) == pytest.approx(45.0)
    assert _read("cg_active_share.foldin", t) == pytest.approx(45.0)


def test_serve_readers_split_gaps_across_spans(registry):
    t = _trace()
    assert _read("host_prep_idle_ms.serve", t, calls=2) is None
    assert _read("replay_idle_ms.serve", t, calls=2) is None
    # pack over [105, 115]: idle 5 of it; bucket pattern over [145, 175]:
    # idle 20 (the gap [150, 170]); pad over [185, 190] and a second pad
    # overlapping it, counted once: idle 5
    _span(registry, "serve/fold_in/pack", 105, 115)
    _span(registry, "serve/fold_in/bucket_pattern", 145, 175)
    _span(registry, "serve/top_k/pad", 185, 190)
    _span(registry, "serve/top_k/pad", 186, 189)
    _span(registry, "serve/fold_in/pack", 95, 105)     # outside
    _span(registry, "serve/graph/replay", 115, 155)    # idle 5
    _span(registry, "serve/graph/replay", 160, 175)    # idle 10
    _span(registry, "serve/readback", 180, 200)        # another phase
    assert _read("host_prep_idle_ms.serve", t, calls=2) == \
        pytest.approx(15.0)
    assert _read("replay_idle_ms.serve", t, calls=3) == pytest.approx(5.0)
    assert _read("replay_idle_ms.serve", t, calls=0) is None


def test_idle_intersection_against_a_direct_sum():
    """The gap and span intersection equals a millisecond-by-millisecond
    count over random layouts."""
    import random
    idle_ns = spec.load_reader("host_prep_idle_ms.serve").idle_ns
    rng = random.Random(5)
    for _ in range(50):
        cuts = sorted(rng.sample(range(0, 200), 12))
        gaps = list(zip(cuts[::2], cuts[1::2]))
        spans = []
        for _ in range(rng.randrange(0, 6)):
            a = rng.randrange(0, 200)
            spans.append((a, a + rng.randrange(1, 40)))
        want = sum(1 for ms in range(0, 240)
                   if any(a <= ms < b for a, b in gaps)
                   and any(a <= ms < b for a, b in spans))
        assert idle_ns(gaps, spans) == want


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reads_the_new_metrics(cell, registry):
    """A traced CPU run of each small cell: tracing is live for the
    profiler's window alone, and every new metric the cell names reads,
    but ``replay_idle_ms.serve`` (the CPU replays no graph). Fold-in's
    eager CG is counted once a call."""
    b = bench()
    torch.manual_seed(0)
    r = run.execute(b, spec.resolve(b, cell), 3000000021, 0.3, True, "cpu",
                    small(cell))
    assert r["correct"]
    named = [m for m in spec.per_layer_metrics(b, cell) if m in NEW]
    got = {m: r["metrics"][m]["value"] for m in named if m in r["metrics"]}
    want = set(named) - {"replay_idle_ms.serve"}
    assert set(got) == want, json.dumps(r["metrics"])
    for m, v in got.items():
        assert v >= 0
        if "share" in m:
            assert 0 < v <= 100
    # the profiler alone made tracing live: set-up's calls and sweeps and
    # the reference ran without it, so only the window's calls are logged
    calls = {"function-312m.als": "complete/rmse",
             "function-78m.ggn-poisson": "complete/rmse",
             "netflix-r32.foldin": "serve/fold_in/pack",
             "netflix-r32.topk": "serve/top_k/pad"}[cell]
    assert len(registry.spans(calls)) == r["attempted"]
    log = registry.counter_log("cg/")
    if cell == "netflix-r32.foldin":
        from repro_torch.serve import foldin
        budget = foldin.cg_budget(spec.resolve(b, cell).config["rank"])
        assert sum(v for n, _, v in log if n == "cg/iterations") == \
            r["attempted"] * budget
    if cell == "netflix-r32.topk":
        assert log == []
