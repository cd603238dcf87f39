"""The PyTorch port's kernel-tile tuner and plan cache
(``repro_torch.planner.tuner``, ``repro_torch.kernels.tile``) on the CPU,
case for case against the reference's ``tests/test_tuner.py``: lattice
sweep, winner installation, obs counters and plan records, and the
persistent on-disk plan cache (a second run of a cached workload performs
no timing at all, asserted on the tuner's counters), plus the footprint
budget in the cache key. On the CPU the wrappers run their plain versions
and ignore the launch knobs, so the winners here are noise; what is held
is the bookkeeping.

Parity with the JAX package on shared numpy arrays: ``plan_signature``
equal as strings, ``_family_ir`` with the same expression and kind, and
each family's predicted cost terms (flops, memory and communication words)
exactly equal, the seconds too under the reference's rates."""
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.planner import cost as jcost
from repro.planner import tuner as jtuner

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import obs  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import tile as ktile  # noqa: E402
from repro_torch.kernels.tile import KernelTile  # noqa: E402
from repro_torch.launch import complete  # noqa: E402
from repro_torch.launch import experiment  # noqa: E402
from repro_torch.planner import cost as pcost  # noqa: E402
from repro_torch.planner import tuner  # noqa: E402

# small lattices keep the sweeps fast; default-first ordering mirrors the
# production lattices (winner <= default by construction)
TEST_LATTICES = {
    "tttp": (KernelTile(), KernelTile(threads=128)),
    "mttkrp": (KernelTile(), KernelTile(threads=128, per_thread=4)),
    "cg_matvec": (KernelTile(), KernelTile(per_thread=1)),
}
SHAPE = (24, 18, 12)


def _arrays(seed=0, nnz=120, cap=140, r=8):
    rng = np.random.default_rng(seed)
    idx = np.zeros((cap, 3), np.int32)
    idx[:nnz] = np.stack([rng.integers(0, s, nnz) for s in SHAPE], 1)
    vals = np.zeros(cap, np.float32)
    vals[:nnz] = rng.uniform(-1, 1, nnz)
    valid = np.arange(cap) < nnz
    factors = [rng.standard_normal((s, r)).astype(np.float32)
               for s in SHAPE]
    return idx, vals, valid, factors


def _port(arrays):
    idx, vals, valid, factors = arrays
    st = SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                      torch.from_numpy(valid), SHAPE, int(valid.sum()))
    return st, [torch.from_numpy(f) for f in factors]


def _reference(arrays):
    idx, vals, valid, factors = arrays
    st = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals),
                       jnp.asarray(valid), SHAPE, nnz=int(valid.sum()))
    return st, [jnp.asarray(f) for f in factors]


@pytest.fixture
def problem(monkeypatch):
    monkeypatch.setattr(tuner, "LATTICES", TEST_LATTICES)
    st, factors = _port(_arrays())
    omega = st.with_values(torch.ones_like(st.values))
    yield st, factors, omega
    ktile.reset_tiles()
    pcost.reset_rates()


@pytest.fixture
def registry():
    obs.enable()
    reg = obs.get_registry()
    reg.reset()
    yield reg
    obs.disable()
    reg.reset()


def _counter(reg, name):
    return reg.counters.get(name, 0.0)


def test_tune_family_installs_winner(problem, registry):
    st, factors, omega = problem
    result = tuner.tune_family("mttkrp", st, factors, omega=omega, iters=1)
    assert result["tile"] in TEST_LATTICES["mttkrp"]
    assert ktile.current_tile("mttkrp") == result["tile"]
    assert result["seconds"] == min(s for _, s in result["timings"])
    assert result["seconds"] > 0
    assert result["footprint_pruned"] == []


def test_tune_family_counters_and_plan_records(problem, registry):
    st, factors, omega = problem
    kops.reset_launch_counts()
    tuner.tune_family("tttp", st, factors, iters=1)
    assert _counter(registry, "tuner/measurements") \
        == len(TEST_LATTICES["tttp"])
    keys = [k for k in registry.plans if k.startswith("autotune/tttp|")]
    assert sorted(keys) == sorted(f"autotune/tttp|all_at_once|tile:"
                                  f"{t.short()}"
                                  for t in TEST_LATTICES["tttp"])
    for k in keys:
        rec = registry.plans[k]
        assert rec.measured.count >= 1
        assert rec.predicted["seconds"] > 0
    # the tuner's own calls are taken back out of the launch counts
    assert kops.launch_counts() == {"tttp": 0, "mttkrp": 0, "cg_matvec": 0}
    # a timed call runs in its candidate's tile, as its kernel span shows
    assert "tuner/tttp/kernel/tttp" in registry.timings
    root, last = obs.last_root(), TEST_LATTICES["tttp"][-1].short()
    assert root["name"] == "tuner/tttp" and root["attrs"]["tile"] == last
    assert [c["attrs"]["tile"] for c in root["children"]] == [last]


def test_second_run_zero_measurements(problem, registry, tmp_path):
    """A rerun against the populated cache performs no timing: every
    family is a cache hit, the winners and the calibrated rates return."""
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    s1 = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                            iters=1)
    assert s1["hits"] == 0 and s1["measured"] == 6
    assert _counter(registry, "tuner/calibrations") == 1
    measured_after_first = _counter(registry, "tuner/measurements")
    winners1 = dict(s1["winners"])

    ktile.reset_tiles()
    pcost.reset_rates()
    s2 = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                            iters=1)
    assert s2["measured"] == 0
    assert s2["hits"] == 3
    assert _counter(registry, "tuner/measurements") == measured_after_first
    assert _counter(registry, "tuner/cache_hits") == 3
    assert s2["winners"] == winners1
    assert s2["rates"] == s1["rates"]
    for f in ("tttp", "mttkrp", "cg_matvec"):
        assert ktile.current_tile(f).short() == winners1[f]


def test_cache_misses_on_lattice_version_bump(problem, registry, tmp_path,
                                              monkeypatch):
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache, iters=1)
    monkeypatch.setattr(tuner, "LATTICE_VERSION", tuner.LATTICE_VERSION + 1)
    s = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                           iters=1)
    assert s["hits"] == 0 and s["measured"] > 0


def test_cache_misses_on_device_kind_change(problem, registry, tmp_path,
                                            monkeypatch):
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache, iters=1)
    monkeypatch.setattr(tuner, "device_kind",
                        lambda tensor=None: "NVIDIA H200")
    s = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                           iters=1)
    assert s["hits"] == 0 and s["measured"] > 0


def test_cache_misses_on_signature_change(problem, registry, tmp_path):
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache, iters=1)
    f2 = [f[:, :4].contiguous() for f in factors]  # another rank
    s = tuner.ensure_tuned(st, f2, omega=omega, cache_path=cache, iters=1)
    assert s["hits"] == 0 and s["measured"] > 0


def test_cache_misses_on_footprint_budget_change(problem, registry,
                                                 tmp_path, monkeypatch):
    """A winner tuned under one shared-memory budget may be unrunnable
    under a smaller one: the budget is part of the key."""
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache, iters=1)
    monkeypatch.setenv("REPRO_SMEM_KB", "100")
    s = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                           iters=1)
    assert s["hits"] == 0 and s["measured"] == 6
    assert all(k.endswith("|smem=102400") or k.endswith("|smem=232448")
               for k in json.load(open(cache))["entries"])


def test_cache_file_shape(problem, tmp_path):
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache, iters=1)
    with open(cache) as f:
        data = json.load(f)
    assert set(data) == {"lattice_version", "entries", "rates"}
    assert data["lattice_version"] == tuner.LATTICE_VERSION
    assert len(data["entries"]) == 3
    for key, entry in data["entries"].items():
        dev, ver, family, sig = key.split("|", 3)
        assert dev == "cpu"
        assert ver == f"v{tuner.LATTICE_VERSION}"
        assert family in ("tttp", "mttkrp", "cg_matvec")
        assert "shape=24x18x12" in sig and sig.endswith("|smem=232448")
        tile = KernelTile.from_json(entry["tile"])  # round-trips
        assert tile in TEST_LATTICES[family]
    assert data["rates"]["flop"] > 0


def test_corrupt_cache_file_is_remeasured(problem, tmp_path):
    st, factors, omega = problem
    cache = str(tmp_path / "plan_cache.json")
    with open(cache, "w") as f:
        f.write("{not json")
    s = tuner.ensure_tuned(st, factors, omega=omega, cache_path=cache,
                           iters=1)
    assert s["measured"] > 0
    with open(cache) as f:
        json.load(f)  # rewritten valid


def test_no_cache_path_always_measures(problem, monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    st, factors, omega = problem
    s1 = tuner.ensure_tuned(st, factors, omega=omega, cache_path="", iters=1,
                            families=("tttp",))
    s2 = tuner.ensure_tuned(st, factors, omega=omega, cache_path="", iters=1,
                            families=("tttp",))
    assert s1["measured"] > 0 and s2["measured"] > 0


def test_cg_matvec_skipped_without_omega(problem):
    st, factors, _ = problem
    s = tuner.ensure_tuned(st, factors, iters=1)
    assert set(s["winners"]) == {"tttp", "mttkrp"}


def test_fenced_time_lands_in_registry(registry):
    t = tuner.fenced_time(lambda: torch.zeros(8), iters=2,
                          span_name="tuner/unit")
    assert t > 0
    assert any(k.startswith("tuner/unit") for k in registry.timings)


def test_calibrate_roundtrip():
    try:
        before = pcost.rates()
        got = pcost.calibrate([(1e6, 1e5, 1e-3), (4e6, 2e5, 3.5e-3)])
        assert got["flop"] > 0 and got["mem"] > 0
        assert pcost.rates() == got
        with pytest.raises(ValueError):
            pcost.set_rates(flop=-1.0)
    finally:
        pcost.reset_rates()
    assert pcost.rates() == {"flop": pcost.FLOP_RATE, "mem": pcost.MEM_RATE,
                             "comm": pcost.COMM_RATE}
    assert before == pcost.rates()


def test_complete_cli_plan_cache_round_trip(tmp_path, capsys, monkeypatch):
    """The second ``launch.complete --plan-cache`` run measures nothing (a
    cache hit on every family) and sweeps to the same RMSE; the
    ``REPRO_PLAN_CACHE`` variable does what the flag does."""
    monkeypatch.setattr(tuner, "LATTICES", TEST_LATTICES)
    cache = tmp_path / "plan.json"
    argv = ["--device", "cpu", "--dims", "24,18,12", "--nnz", "500",
            "--rank", "6", "--sweeps", "1"]

    def run(extra):
        r = complete.main(argv + extra)
        out = capsys.readouterr().out
        m = re.search(r"plan-cache: hits=(\d+) measured=(\d+) "
                      r"footprint_pruned=(\d+) winners=", out)
        assert m, out
        return r, tuple(int(g) for g in m.groups())

    try:
        r1, (hits, measured, pruned) = run(["--plan-cache", str(cache)])
        assert hits == 0 and measured == 6 and pruned == 0
        monkeypatch.setenv("REPRO_PLAN_CACHE", str(cache))
        r2, (hits, measured, pruned) = run([])
        assert hits == 3 and measured == 0
        assert r2.history[-1][2] == pytest.approx(r1.history[-1][2],
                                                  rel=1e-5)
    finally:
        ktile.reset_tiles()
        pcost.reset_rates()


def test_run_experiment_plan_cache_report(tmp_path, capsys, monkeypatch):
    """``run_experiment(plan_cache=)`` tunes before the first run and the
    report carries ``plan_cache`` with the reference's keys (its
    ``vmem_pruned`` is ``footprint_pruned`` here)."""
    monkeypatch.setattr(tuner, "LATTICES", TEST_LATTICES)
    spec = experiment.SPECS["netflix-ci"]
    spec = type(spec)(**{**spec.__dict__, "nnz": 2000, "sweeps": 1})
    cache = str(tmp_path / "plan.json")
    try:
        report = experiment.run_experiment(
            spec, out_dir=str(tmp_path), algorithms=("als",),
            losses=("quadratic",), plan_cache=cache, device="cpu")
    finally:
        ktile.reset_tiles()
        pcost.reset_rates()
    assert "plan-cache: hits=0 measured=6" in capsys.readouterr().out
    pc = report["plan_cache"]
    assert set(pc) == {"path", "hits", "measured", "footprint_pruned",
                       "winners"}
    assert pc["path"] == cache and pc["measured"] == 6
    assert set(pc["winners"]) == {"tttp", "mttkrp", "cg_matvec"}


# ---------------------------------------------------------------------------
# KernelTile and the tile table
# ---------------------------------------------------------------------------

def test_default_tile_is_the_untuned_launch():
    t = ktile.DEFAULT_TILE
    assert (t.block_rows, t.threads, t.per_thread, t.accum_dtype) \
        == (8, 256, 2, "float32")
    assert t.short() == "br8.t256.p2.f32"
    for family, lattice in tuner.LATTICES.items():
        assert lattice[0] == t, family
        assert len(set(lattice)) == len(lattice)


@pytest.mark.parametrize("tile", sorted(
    {t for lat in tuner.LATTICES.values() for t in lat},
    key=lambda t: t.short()), ids=lambda t: t.short())
def test_kernel_tile_json_round_trip(tile):
    assert KernelTile.from_json(json.loads(json.dumps(tile.to_json()))) \
        == tile
    assert hash(tile) == hash(KernelTile.from_json(tile.to_json()))


@pytest.mark.parametrize("kwargs,match", [
    (dict(accum_dtype="bfloat16"), "accumulate in float32 only"),
    (dict(threads=96 + 1), "multiple of 32"),
    (dict(threads=512), "multiple of 32"),
    (dict(per_thread=3), "per_thread"),
    (dict(block_rows=0), "block_rows")])
def test_kernel_tile_refuses_what_the_kernels_do_not_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        KernelTile(**kwargs)


def test_tile_table_set_and_reset():
    t = KernelTile(threads=128, per_thread=4)
    try:
        ktile.set_tile("mttkrp", t)
        assert ktile.current_tile("mttkrp") == t
        assert tuner.tiles_summary() == {"tttp": "br8.t256.p2.f32",
                                         "mttkrp": "br8.t128.p4.f32",
                                         "cg_matvec": "br8.t256.p2.f32"}
        with pytest.raises(KeyError, match="unknown kernel family"):
            ktile.set_tile("conv", t)
    finally:
        ktile.reset_tiles()
    assert ktile.current_tile("mttkrp") == ktile.DEFAULT_TILE


def test_wrapper_span_carries_the_resolved_tile(registry):
    """An explicit tile wins over the table, the table over the default;
    the ``kernel/<family>`` span carries the tile that resolved."""
    st, factors = _port(_arrays())
    t = KernelTile(threads=64, per_thread=4)
    try:
        ktile.set_tile("tttp", KernelTile(threads=128))
        with obs.span("root"):
            kops.tttp_values(st, factors)
            kops.tttp_values(st, factors, tile=t)
            bk = st.row_buckets(0, 8)
            kops.mttkrp_bucketed(bk, [None] + factors[1:])
    finally:
        ktile.reset_tiles()
    kids = obs.last_root()["children"]
    assert [(c["name"], c["attrs"]["tile"]) for c in kids] == [
        ("kernel/tttp", "br8.t128.p2.f32"), ("kernel/tttp", t.short()),
        ("kernel/mttkrp_bucketed", "br8.t256.p2.f32")]


# ---------------------------------------------------------------------------
# parity with the reference's tuner
# ---------------------------------------------------------------------------

def test_plan_signature_matches_reference():
    arrays = _arrays(seed=3)
    st, fs = _port(arrays)
    jst, jfs = _reference(arrays)
    assert tuner.plan_signature(st, fs) == jtuner.plan_signature(jst, jfs)
    assert tuner.plan_signature(st, fs) == \
        "shape=24x18x12|nnz=120|cap=140|r=8|dt=float32"


@pytest.mark.parametrize("family", ["tttp", "mttkrp", "cg_matvec"])
def test_family_ir_and_predicted_terms_match_reference(family):
    """Same expression and kind; the predicted flops, memory and
    communication words exactly equal; the seconds equal under the
    reference's rates."""
    arrays = _arrays(seed=4)
    st, fs = _port(arrays)
    jst, jfs = _reference(arrays)
    ir, jir = tuner._family_ir(family, st, fs), \
        jtuner._family_ir(family, jst, jfs)
    assert ir.expr == jir.expr and str(ir.kind) == str(jir.kind)
    path = tuner._FAMILY_PATH[family]
    assert path == jtuner._FAMILY_PATH[family]
    got, want = pcost.estimate(ir, path), jcost.estimate(jir, path)
    assert (got.flops, got.mem, got.comm) == (want.flops, want.mem,
                                              want.comm)
    try:
        pcost.set_rates(**jcost.rates())
        assert got.seconds == want.seconds
    finally:
        pcost.reset_rates()
