"""The PyTorch port's roofline layer on the CPU: ``obs.profile``
(``Machine``, ``profile_fn``), ``launch.roofline`` (``kernel_terms``,
``profiler_terms``), the Hopper footprint model (``kernels.footprint``)
and the perf report (``launch.report``).

* ``Machine`` defaults to the H100 SXM data sheet; ``REPRO_PEAK_FLOPS``,
  ``REPRO_HBM_BW`` and ``REPRO_LINK_BW`` override it;
* ``profiler_terms`` counts exactly 2·m·n·k flops for a plain matrix
  product and none for a gather plus ``index_add_`` (the counterparts of
  the reference's ``tests/test_roofline.py`` pure-dot and gather/segment
  cases);
* ``kernel_terms`` at the main path's shapes gives ``PERF.md``'s bounds;
* the footprint model's shared memory for known shapes, a prune forced by
  ``REPRO_SMEM_KB``, the tuner's error when every candidate is pruned, and
  the build-log parser behind its register counts;
* ``launch.report --device cpu`` writes its report where ``--out`` says
  and nowhere else.

No test here measures a device: the times a CPU run takes describe the
CPU."""
import os
import sys

import numpy as np
import pytest
import torch

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import obs  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import footprint  # noqa: E402
from repro_torch.kernels import tile as ktile  # noqa: E402
from repro_torch.kernels.tile import KernelTile  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.planner import cost as pcost  # noqa: E402
from repro_torch.planner import tuner  # noqa: E402

# what ``-Xptxas -v`` prints for two entry functions (one spilling)
PTXAS_LOG = """== mttkrp.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118bucket_rows_kernelILi16ELb0ELi2EfEEvPKT2_PKiS4_PKhxii11FactorTableIS2_ES3_xiiiPS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118bucket_rows_kernelILi16ELb0ELi2EfEEvPKT2_PKiS4_PKhxii11FactorTableIS2_ES3_xiiiPS2_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 456 bytes cmem[0]
== tttp.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111tttp_kernelILi3ELi4EfEEvPKT1_PKiPKhxi14PresentFactorsIS0_EiiPS0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111tttp_kernelILi3ELi4EfEEvPKT1_PKiPKhxi14PresentFactorsIS0_EiiPS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 400 bytes cmem[0]
== tttp_bf16.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111tttp_kernelILi3ELi4E13__nv_bfloat16EEvPKT1_PKiPKhxi14PresentFactorsIS0_EiiPS0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111tttp_kernelILi3ELi4E13__nv_bfloat16EEvPKT1_PKiPKhxi14PresentFactorsIS0_EiiPS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, 0 bytes smem, 400 bytes cmem[0]
"""


@pytest.fixture(autouse=True)
def _clean():
    yield
    ktile.reset_tiles()
    pcost.reset_rates()
    obs.disable()
    obs.get_registry().reset()


def _problem(seed=0, shape=(40, 30, 20), nnz=600, r=10):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    st = SparseTensor(torch.from_numpy(idx.astype(np.int32)),
                      torch.from_numpy(rng.uniform(-1, 1, nnz)
                                       .astype(np.float32)),
                      torch.ones(nnz, dtype=torch.bool), shape, nnz)
    fs = [torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
          for s in shape]
    return st, fs


# ---------------------------------------------------------------------------
# Machine and profile_fn
# ---------------------------------------------------------------------------

def test_machine_defaults_to_the_h100_data_sheet(monkeypatch):
    for var in ("REPRO_PEAK_FLOPS", "REPRO_HBM_BW", "REPRO_LINK_BW"):
        monkeypatch.delenv(var, raising=False)
    m = obs.Machine.from_env()
    assert (m.peak_flops, m.hbm_bw, m.link_bw) == (67e12, 3.35e12, 450e9)


@pytest.mark.parametrize("var,field", [("REPRO_PEAK_FLOPS", "peak_flops"),
                                       ("REPRO_HBM_BW", "hbm_bw"),
                                       ("REPRO_LINK_BW", "link_bw")])
def test_machine_env_overrides(monkeypatch, var, field):
    monkeypatch.setenv(var, "1.5e9")
    assert getattr(obs.Machine.from_env(), field) == 1.5e9


def test_profiler_terms_of_a_matmul_are_exact():
    a, b = torch.ones(32, 48), torch.ones(48, 16)
    t = rl.profiler_terms(lambda x, y: x @ y, a, b)
    assert t["flops"] == 2 * 32 * 48 * 16
    assert t["profiler_flops"] == t["flops"]
    # mm reads both operands and writes the product
    assert t["bytes"] >= 4 * (32 * 48 + 48 * 16 + 32 * 16)
    assert t["collective_bytes"] == 0.0


def test_gather_and_index_add_have_no_matmul_flops():
    """The sparse gather/scatter paths run no matrix product: the terms
    report 0 rather than inventing flops, and the memory term is what
    the roofline reads."""
    idx = torch.arange(64) % 8
    vals = torch.ones(64, 4)
    f = torch.ones(8, 4)
    t = rl.profiler_terms(
        lambda i, v, a: torch.zeros(8, 4).index_add_(0, i, a[i]), idx,
        vals, f)
    assert t["flops"] == 0.0
    assert t["bytes"] > 0.0


def test_kernel_terms_reproduce_the_main_path_bounds():
    """PERF.md §6: 20000³, 80 M nonzeros, R = 10; 2500 buckets × 32 560
    slots of block_rows 8: TTTP 0.502 ms, the MTTKRP and the fused matvec
    0.511 ms, all bound by bytes at 3.35 TB/s."""
    tttp = rl.kernel_terms("tttp", slots=80_000_000, nd=3, rank=10,
                           valid=80_000_000, factor_rows=(20000,) * 3)
    ms, by = rl.bound(tttp["bytes"], tttp["flops"])
    assert (round(ms, 3), by) == (0.502, "bytes")
    for family in ("mttkrp", "cg_matvec"):
        t = rl.kernel_terms(family, slots=2500 * 32560, nd=3, rank=10,
                            valid=80_000_000, factor_rows=(20000,) * 2,
                            out_rows=2500 * 8, x_rows=20000)
        ms, by = rl.bound(t["bytes"], t["flops"])
        assert (round(ms, 3), by) == (0.511, "bytes"), family


def test_kernel_terms_valid_only_counts_entries_not_slots():
    padded = rl.kernel_terms("cg_matvec", slots=1000, nd=3, rank=8,
                             valid=100, factor_rows=(5, 5), out_rows=8,
                             x_rows=8)
    valid = rl.kernel_terms("cg_matvec", slots=1000, nd=3, rank=8,
                            valid=100, factor_rows=(5, 5), out_rows=8,
                            x_rows=8, valid_only=True)
    assert padded["bytes"] - valid["bytes"] == 900 * 21
    assert padded["flops"] == valid["flops"] == 100 * 8 * 5
    with pytest.raises(KeyError):
        rl.kernel_terms("conv", slots=1, nd=3, rank=1, valid=1,
                        factor_rows=(1,))


def test_profile_fn_report_and_gauge():
    a = torch.ones(64, 64)
    rep = obs.profile_fn(lambda x: x @ x, a, name="sq", iters=2)
    assert set(rep) == {"name", "measured_s", "flops", "bytes",
                        "collective_bytes", "compute_s", "memory_s",
                        "collective_s", "dominant", "frac_peak_compute",
                        "frac_peak_memory", "frac_roofline", "machine"}
    assert rep["measured_s"] > 0
    assert rep["flops"] == 2 * 64 ** 3
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert 0 < rep["frac_roofline"] <= 1.0
    assert rep["machine"]["peak_flops"] > 0
    assert obs.get_registry().summary()["gauges"] == {}
    obs.enable()
    rep = obs.profile_fn(lambda x: x @ x, a, name="sq", iters=1,
                         terms={"flops": 1.0, "bytes": 2.0})
    summ = obs.get_registry().summary()
    assert summ["gauges"]["roofline/sq/frac_roofline"] == \
        rep["frac_roofline"]
    assert summ["timings"]["roofline/sq"]["count"] == 1


# ---------------------------------------------------------------------------
# the footprint model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,r,smem", [
    ("tttp", 10, 0), ("mttkrp", 10, 4 * 8 * 12), ("cg_matvec", 10, 768),
    ("mttkrp", 64, 4 * 8 * 64), ("cg_matvec", 32, 2 * 4 * 8 * 32),
    # R > 128: the MTTKRP's widest column tile, and the Gram matvec runs as
    # TTTP + MTTKRP (no x rows in shared memory)
    ("mttkrp", 160, 4 * 8 * 128), ("cg_matvec", 160, 4 * 8 * 128)])
def test_footprint_shared_memory_of_known_shapes(family, r, smem):
    """``smem`` is a CTA of one warp's shared memory: its slab of 8 output
    rows of RS floats, and the matvec's 8 rows of x. Each further warp adds
    a slab of its own (the deterministic in-bucket sum)."""
    st, fs = _problem(r=r)
    tile = ktile.DEFAULT_TILE
    slab = 0 if family == "tttp" else 4 * 8 * footprint.row_width(r)
    est = footprint.estimate_footprint(
        family, tile, footprint.workload_geometry(family, st, fs, tile))
    assert est.smem_bytes == est.total == smem + 7 * slab
    assert est.fits and est.threads == 256
    assert est.budget == footprint.SMEM_PER_BLOCK_OPTIN
    assert 1 <= est.blocks_per_sm <= 8
    assert f"{smem + 7 * slab} B shared" in est.format()
    one = KernelTile(threads=32)
    assert footprint.estimate_footprint(
        family, one, footprint.workload_geometry(family, st, fs, one)
    ).smem_bytes == smem


def test_footprint_registers_from_the_build_log(monkeypatch):
    usage = _build.resource_usage(PTXAS_LOG)
    assert usage == {
        ("bucket_rows_kernel", (16, 0, 2, "float32")): {
            "registers": 72, "smem": 0, "stack": 8, "spill_stores": 4,
            "spill_loads": 4},
        ("tttp_kernel", (3, 4, "float32")): {
            "registers": 40, "smem": 1024, "stack": 0, "spill_stores": 0,
            "spill_loads": 0},
        ("tttp_kernel", (3, 4, "bfloat16")): {
            "registers": 38, "smem": 0, "stack": 0, "spill_stores": 0,
            "spill_loads": 0}}
    st, fs = _problem()
    geom = footprint.workload_geometry("mttkrp", st, fs, ktile.DEFAULT_TILE)
    est = footprint.estimate_footprint("mttkrp", ktile.DEFAULT_TILE, geom)
    assert est.registers == 255 and est.registers_from == "launch-bounds cap"
    monkeypatch.setattr(_build, "build_log", lambda: PTXAS_LOG)
    est = footprint.estimate_footprint("mttkrp", ktile.DEFAULT_TILE, geom)
    assert (est.registers, est.registers_from) == (72, "build log")
    assert est.kernel == "bucket_rows_kernel<16, 0, 2, float32>"
    # 72 × 32 = 2304 registers a warp (nine 256-register units): 7 warps
    # in each of the 4 sub-partitions' 16384 registers, 28 warps, 3 CTAs of
    # 8 warps
    assert est.blocks_per_sm == 4 * (16384 // (72 * 32)) // 8
    t = KernelTile(per_thread=4)
    est = footprint.estimate_footprint(
        "tttp", t, footprint.workload_geometry("tttp", st, fs, t))
    assert (est.registers, est.static_smem, est.smem_bytes) == (40, 1024,
                                                                1024)
    # the bf16 instantiation has its own entry in the log
    geom = footprint.workload_geometry(
        "tttp", st.astype(torch.bfloat16), [f.bfloat16() for f in fs], t)
    est = footprint.estimate_footprint("tttp", t, geom)
    assert (est.registers, est.kernel) == (38, "tttp_kernel<3, 4, bfloat16>")


def test_forced_prune_and_the_all_pruned_error(monkeypatch):
    """REPRO_SMEM_KB below the bucketed body's output rows prunes every
    MTTKRP candidate: counted, never timed, and the tuner raises; TTTP
    (no shared memory) keeps its whole lattice."""
    st, fs = _problem()
    lattice = tuner.LATTICES["mttkrp"]
    monkeypatch.setenv("REPRO_SMEM_KB", "0.25")
    assert footprint.smem_budget_bytes() == 256
    kept, pruned = footprint.prune_lattice(
        "mttkrp", lattice,
        lambda t: footprint.workload_geometry("mttkrp", st, fs, t))
    assert kept == [] and [t for t, _ in pruned] == list(lattice)
    # one slab of 8 rows of 12 floats (384 B) per warp
    assert all(not e.fits and e.total == 384 * t.threads // 32
               for t, e in pruned)
    assert "OVER" in pruned[0][1].format()
    kept, _ = footprint.prune_lattice(
        "tttp", tuner.LATTICES["tttp"],
        lambda t: footprint.workload_geometry("tttp", st, fs, t))
    assert kept == list(tuner.LATTICES["tttp"])
    obs.enable()
    with pytest.raises(ValueError, match="every 'mttkrp' lattice candidate "
                                         "exceeds the footprint budget"):
        tuner.tune_family("mttkrp", st, fs, iters=1)
    counters = obs.get_registry().summary()["counters"]
    assert counters["tuner/footprint_pruned"] == len(lattice)
    assert "tuner/measurements" not in counters
    # a budget between the MTTKRP's least tile (two warps' slabs, 768 B)
    # and the matvec's (1152 B with x's rows) prunes only the matvec: the
    # summary counts it
    monkeypatch.setenv("REPRO_SMEM_KB", "1.0")
    omega = st.with_values(torch.ones_like(st.values))
    with pytest.raises(ValueError, match="'cg_matvec'"):
        tuner.ensure_tuned(st, fs, omega=omega, iters=1, cache_path="")


def test_dynamic_smem_is_the_launch_check(monkeypatch):
    """One statement of the limit: the MTTKRP's launch check reads the
    footprint module's bytes and opt-in limit."""
    # one warp: its slab, and the matvec's rows of x; 256 threads: 8 slabs
    assert footprint.dynamic_smem_bytes(8, 10, False, threads=32) == 384
    assert footprint.dynamic_smem_bytes(8, 10, True, threads=32) == 768
    assert footprint.dynamic_smem_bytes(8, 10, False) == 8 * 384
    assert footprint.dynamic_smem_bytes(8, 10, True) == 9 * 384
    # a float64 accumulator over float32 operands: 8-byte slabs, x in float
    assert footprint.dynamic_smem_bytes(8, 10, True, torch.float32, 256,
                                        torch.float64) == 8 * 768 + 384
    rows = footprint.SMEM_PER_BLOCK_OPTIN // (4 * 128 * 9)
    assert footprint.dynamic_smem_bytes(rows, 128, True) \
        <= footprint.SMEM_PER_BLOCK_OPTIN \
        < footprint.dynamic_smem_bytes(rows + 1, 128, True)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def test_report_writes_out_and_no_perf_md(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "report.md"
    perf = report.main(["--device", "cpu", "--spec", "netflix-ci",
                        "--repeats", "1", "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["report.md"]
    text = out.read_text()
    assert {p["kind"] for p in perf["plans"].values()} == {
        "mttkrp", "tttp", "cg_matvec"}
    assert [r["name"] for r in perf["rooflines"]] == [
        "mttkrp_bucketed", "tttp", "cg_matvec_bucketed"]
    assert perf["device"] == "cpu"
    for r in perf["rooflines"]:
        assert r["tile"] == "br8.t256.p2.f32" and r["measured_s"] > 0
        assert f"| {r['name']} | br8.t256.p2.f32 |" in text
    assert "_no committed BENCH_torch_*.json_" in text
    # without --out the report goes to stdout
    report.main(["--device", "cpu", "--spec", "netflix-ci", "--repeats",
                 "1"])
    assert "# Performance report" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["report.md"]
