"""The port's SPMD passes (``repro_torch.analysis.spmd``): the
collective-matching lint (SP101–SP103) and the lattices' shared-memory and
register certificate (SP201), after the JAX package's ``tests/test_spmd.py``
where a torch meaning exists. The seeded-bug fixtures are strings written
to ``tmp_path``; each must make the CLI report exactly its planted rule.
The sharding interpreter (SP001–SP004) has its own file,
``tests/test_torch_sharding.py``; here only its CLI wiring."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.analysis.spmd import collectives, footprint
from repro_torch.analysis.spmd.cli import main as spmd_main
from repro_torch.kernels import footprint as kfootprint
from repro_torch.kernels.tile import KernelTile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXTURES = {
    # a collective issued on one branch of a rank test: ranks that skip it
    # leave the others waiting (the group is threaded, so no SP103)
    "SP101": '''\
import torch.distributed as dist
from repro_torch.core import collectives as coll


def exchange(x, ctx):
    if dist.get_rank() == 0:
        x = coll.all_reduce(x, ctx.data_group)
    return x
''',
    # each rank's own residual sets how many all-reduces it issues
    "SP102": '''\
from repro_torch.core import collectives as coll


def refine(x, tol, group):
    while x.norm() > tol:
        x = coll.all_reduce(x, group) * 0.5
    return x
''',
    # the world's default group, not the ctx's
    "SP103": '''\
from repro_torch.core import collectives as coll


def total(x):
    return coll.all_reduce(x)
''',
    # a fused-matvec tile whose bucket rows cannot fit a CTA's shared
    # memory: 512 rows of 128 floats, twice (the sums and x)
    "SP201": '''\
FAMILY = "cg_matvec"
TILE = {"threads": 256, "per_thread": 2}
GEOMETRY = {"nd": 3, "rank": 128, "factor_rows": (17_770, 2_182),
            "capacity": 4096, "block_rows": 512, "x_rows": 480_189,
            "dtype": "bfloat16"}
''',
}


def lint(src, path="snippet.py"):
    return [f for f in collectives.lint_source(src, path)
            if not f.suppressed]


def rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture
def fixture_file(tmp_path):
    def write(rule):
        p = tmp_path / f"spmd_{rule.lower()}.py"
        p.write_text(FIXTURES[rule])
        return str(p)
    return write


# ---------------------------------------------------------------------------
# the seeded-bug fixtures
# ---------------------------------------------------------------------------

class TestFixtures:
    @pytest.mark.parametrize("planted", sorted(FIXTURES))
    def test_fixture_reports_exactly_its_planted_rule(self, fixture_file,
                                                      planted):
        from repro_torch.analysis.spmd.cli import check_fixture
        assert rules(check_fixture(fixture_file(planted))) == [planted]

    @pytest.mark.parametrize("planted", sorted(FIXTURES))
    def test_cli_expect_contract(self, fixture_file, planted, capsys):
        path = fixture_file(planted)
        assert spmd_main(["--fixture", path, "--expect", planted]) == 0
        other = "SP103" if planted != "SP103" else "SP101"
        assert spmd_main(["--fixture", path, "--expect", other]) == 1
        assert spmd_main(["--fixture", path]) == 1
        assert planted in capsys.readouterr().out

    def test_sharding_fixture_goes_to_the_interpreter(self, tmp_path):
        """A fixture with ``run`` and ``IN_STATES`` is the sharding
        interpreter's: a data-sharded sum returned without an all-reduce
        is a partial-sum escape."""
        from repro_torch.analysis.spmd.cli import check_fixture
        p = tmp_path / "spmd_missing_psum.py"
        p.write_text("import torch\nAXIS_ENV = (('data', 2),)\n"
                     "ARGS = (torch.ones(8),)\n"
                     "IN_STATES = ({'data': ('shard', 0)},)\n"
                     "EXPECTED = {'data': 'rep'}\n"
                     "def run(x):\n    return x.sum()\n")
        assert rules(check_fixture(str(p))) == ["SP001"]


# ---------------------------------------------------------------------------
# SP101-SP103
# ---------------------------------------------------------------------------

class TestCollectives:
    def test_branch_divergence_on_a_rank_test(self):
        for test in ("dist.get_rank() == 0", "ctx.data_index() == 1",
                     "layout.rank == 0"):
            src = (f"def f(x, ctx, layout):\n    if {test}:\n"
                   f"        x = ctx.psum_data(x)\n    return x\n")
            assert rules(lint(src)) == ["SP101"], test

    def test_branch_divergence_on_a_rank_local_tensor(self):
        src = ("def f(x, group):\n    if (x > 0).any():\n"
               "        x = coll.all_reduce(x, group)\n    return x\n")
        assert rules(lint(src)) == ["SP101"]
        src = ("def f(x, group):\n"
               "    return coll.all_gather(x, group) if x.sum() > 0 else x\n")
        assert rules(lint(src)) == ["SP101"]

    def test_branches_with_the_same_sequence_are_legal(self):
        src = ("def f(x, ctx):\n    if dist.get_rank() == 0:\n"
               "        x = ctx.psum_data(x * 2)\n    else:\n"
               "        x = ctx.psum_data(x)\n    return x\n")
        assert lint(src) == []

    def test_uniform_configuration_guard_is_legal(self):
        src = ("def f(x, ctx, path):\n    if ctx.model is not None:\n"
               "        x = ctx.psum_model(x)\n    if path == 'fused':\n"
               "        x = coll.all_reduce(x, ctx.data_group)\n"
               "    return x\n")
        assert lint(src) == []

    def test_reduced_predicate_is_legal(self):
        src = ("def f(x, tol, group):\n"
               "    err = coll.all_reduce(x.norm(), group)\n"
               "    while err.item() > tol:\n"
               "        x = x * 0.5\n"
               "        err = coll.all_reduce(x.norm(), group)\n"
               "    if err > tol:\n"
               "        x = coll.all_reduce(x, group)\n"
               "    return x\n")
        assert lint(src) == []

    def test_loop_on_an_unreduced_tensor_is_sp102(self):
        src = ("def f(x, tol, ctx):\n    r = x.norm()\n"
               "    while r > tol:\n        x = ctx.psum_data(x) * 0.5\n"
               "        r = x.norm()\n    return x\n")
        assert rules(lint(src)) == ["SP102"]

    @pytest.mark.parametrize("call", [
        "coll.all_reduce(x)", "coll.all_reduce(x, None)",
        "coll.all_gather(x, group=dist.group.WORLD)",
        "coll.reduce_scatter(x, dist.new_group([0, 1]))",
        "coll.barrier()", "coll.broadcast(x, 0)",
        "dist.all_reduce(x, group=ctx.data_group)",
        "torch.distributed.barrier()"])
    def test_collective_outside_the_ctx_is_sp103(self, call):
        src = f"def f(x, ctx):\n    return {call}\n"
        assert rules(lint(src, "port/repro_torch/sparse/x.py")) == ["SP103"]

    def test_the_wrapper_module_may_call_torch_distributed(self):
        src = ("def all_reduce(x, group=None):\n"
               "    dist.all_reduce(x, group=group)\n    return x\n")
        assert lint(src, "port/repro_torch/core/collectives.py") == []
        assert rules(lint(src, "port/repro_torch/core/other.py")) == \
            ["SP103"]

    def test_sp_suppression_with_reason_is_honored(self):
        src = ("def f(x):\n"
               "    # repro-lint: disable=SP103 -- the whole world, on "
               "purpose\n"
               "    return coll.all_reduce(x)\n")
        found = collectives.lint_source(src, "s.py")
        assert [(f.rule, f.suppressed) for f in found] == [("SP103", True)]

    def test_dead_sp_suppression_is_flagged_advisory(self):
        src = ("def f(x, ctx):\n"
               "    # repro-lint: disable=SP101 -- nothing diverges here\n"
               "    return ctx.psum_data(x)\n")
        found = collectives.lint_source(src, "s.py")
        assert [(f.rule, f.advisory) for f in found] == [("JS006", True)]

    def test_covered_modules_are_found_by_import(self):
        assert sorted(collectives.covered_modules(REPO)) == [
            "core/collectives.py", "core/distributed.py",
            "launch/complete.py", "optim/compression.py",
            "runtime/fault_tolerance.py", "sparse/redistribute.py"]

    def test_port_is_collective_clean(self):
        found = collectives.run(REPO)
        assert [f.format() for f in found if not f.suppressed] == []
        assert all(f.reason for f in found if f.suppressed)


# ---------------------------------------------------------------------------
# SP201
# ---------------------------------------------------------------------------

class TestFootprint:
    def test_port_layouts_all_fit_in_both_dtypes(self):
        assert footprint.run() == []

    def test_paper_scale_findings(self):
        """The CUDA kernels keep only a bucket's rows in shared memory, so
        the paper's extents do not enter the footprint: no findings (the
        TPU's VMEM-resident factors overflowed there)."""
        assert footprint.run(paper_scale=True) == []

    def test_a_tight_budget_prunes_the_bucketed_tiles(self, monkeypatch):
        monkeypatch.setenv("REPRO_SMEM_KB", "0.5")
        found = footprint.run()
        assert found and {f.rule for f in found} == {"SP201"}
        assert all("tttp[" not in f.message for f in found)
        assert any("bfloat16" in f.message for f in found)

    def test_registers_limit_warps_per_sub_partition(self):
        """190 registers a thread is 6144 a warp: two warps in each of the
        SM's four 16384-register sub-partitions, 8 warps, 4 CTAs of 64
        threads (what the card's occupancy calculator says), not the 10
        warps of the SM's 65536 registers taken whole."""
        geom = kfootprint.KernelGeometry(nd=3, rank=10, factor_rows=(20, 30),
                                         capacity=64, x_rows=40)
        est = kfootprint.estimate_footprint(
            "cg_matvec", KernelTile(threads=64, per_thread=4), geom)
        est = dataclasses.replace(est, registers=190)
        assert est.blocks_per_sm == 4

    def test_bf16_rows_are_priced_at_their_own_stride(self):
        tile = KernelTile()
        g32, g16 = (kfootprint.KernelGeometry(
            nd=3, rank=10, factor_rows=(20, 30), capacity=64, x_rows=40,
            dtype=dt) for dt in (torch.float32, torch.bfloat16))
        e32 = kfootprint.estimate_footprint("cg_matvec", tile, g32)
        e16 = kfootprint.estimate_footprint("cg_matvec", tile, g16)
        # R = 10: 12 floats a row in float32, 16 values (32 bytes) in bf16;
        # the shared rows are floats either way: a slab of 8 rows per warp
        # (8 warps) and 8 rows of x
        assert (e32.smem_bytes, e16.smem_bytes) == (4 * 8 * 12 * 9,
                                                    4 * 8 * 16 * 9)
        assert e16.kernel == "bucket_rows_kernel<16, 1, 2, bfloat16>"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class TestCli:
    def test_all_exits_zero(self, capsys):
        assert spmd_main(["--all", "--device", "cpu", "--root", REPO,
                          "--strict-suppressions"]) == 0
        out = capsys.readouterr().out
        assert "[collectives] 0 finding(s)" in out and "OK" in out
        assert "[sharding] 0 finding(s)" in out

    def test_sharding_runs_clean_and_show_suppressed_prints(self, capsys):
        assert spmd_main(["--sharding", "--device", "cpu", "--orders",
                          "3"]) == 0
        assert "[sharding] 0 finding(s)" in capsys.readouterr().out
        assert spmd_main(["--collectives", "--root", REPO,
                          "--show-suppressed"]) == 0
        assert "suppressed: " in capsys.readouterr().out

    def test_budget_mb_overrides_the_shared_memory_budget(self, capsys,
                                                          monkeypatch):
        """``--budget-mb`` prices --footprint against the given budget: a
        KB leaves no bucketed tile room for its shared rows. It sets the
        one override the footprint model reads, REPRO_SMEM_KB, for the
        pass only."""
        monkeypatch.delenv("REPRO_SMEM_KB", raising=False)
        assert spmd_main(["--footprint", "--device", "cpu"]) == 0
        capsys.readouterr()
        assert spmd_main(["--footprint", "--device", "cpu", "--budget-mb",
                          "0.001"]) == 1
        out = capsys.readouterr().out
        assert "SP201" in out and "budget 1048 B" in out
        assert "REPRO_SMEM_KB" not in os.environ

    def test_module_entry_point(self):
        env = dict(os.environ, PYTHONPATH=PORT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.spmd", "--all",
             "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip().endswith("OK")
