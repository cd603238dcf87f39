"""The port's static gates (``repro_torch.analysis``), case by case after
the JAX package's ``tests/test_analysis.py`` where a torch meaning exists.

Every lint rule is exercised on a bad snippet it must flag and a good twin
it must not (the fixtures are strings here, written to ``tmp_path`` when a
file is needed); the contract sweep, the cache keys, the aliasing pass and
the dead-code report run clean on the port and fail on a planted fault.
Everything runs on the CPU (``device="cpu"``: the kernels' plain
versions)."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.analysis import contracts, deadcode, lint, pytree_check
from repro_torch.analysis.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_RULES = {"JS001", "JS002", "JS003", "JS004", "JS005"}

BAD_LINT = '''\
import logging
import random
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def js001_if(x):
    if torch.sum(x) > 0:
        return x
    return -x


def js002_item(x):
    return torch.sum(x).item()


def js003_unfenced(f, x):
    t0 = time.perf_counter()
    f(x)
    return time.perf_counter() - t0


def js004_print_loop(xs):
    for x in xs:
        print("step", x)


def js005_torch_global(n):
    return torch.randn(n)
'''

GOOD_LINT = '''\
import time

import numpy as np
import torch


def good_branch(x):
    return torch.where(torch.sum(x) > 0, x, -x)


def good_host_branch(n: int, x):
    if n > 3:
        return x
    return -x


def good_timing(f, x):
    f(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def good_timing_events(f, x):
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    f(x)
    return start.elapsed_time(start), time.perf_counter() - t0


def good_print(xs):
    print("done:", sum(xs))


def good_rng(n, gen):
    rng = np.random.default_rng(1234)
    return rng.standard_normal(3), torch.randn(n, generator=gen)


def good_config_branch(x):
    if torch.cuda.is_available() and torch.is_floating_point(x):
        return x
    return x
'''

BAD_SUPPRESS = '''\
import time


def reasonless(f, x):
    t0 = time.perf_counter()  # repro-lint: disable=JS003
    f(x)
    return time.perf_counter() - t0  # repro-lint: disable=JS003 -- reasonless above stays


def unknown_rule(f, x):
    t0 = time.perf_counter()  # repro-lint: disable=JS999 -- no such rule
    f(x)
    t1 = time.perf_counter()  # repro-lint: disable=JS003 -- a valid one
    return t1 - t0


def comment_line_covers_next(f, x):
    # repro-lint: disable=JS003 -- the comment-only line covers the next
    t0 = time.perf_counter()
    f(x)
    return t0
'''


def rules_hit(findings, suppressed=False):
    return {f.rule for f in findings if f.suppressed == suppressed}


# ---------------------------------------------------------------------------
# pass 1: lint rules, bad snippets vs good twins
# ---------------------------------------------------------------------------

class TestLintRules:
    def test_bad_fixture_hits_every_rule(self):
        findings = lint.lint_source(BAD_LINT, "bad_lint.py", rules=SWEEP_RULES)
        assert rules_hit(findings) == SWEEP_RULES

    def test_good_twin_is_clean(self):
        assert lint.lint_source(GOOD_LINT, "good_lint.py",
                                rules=SWEEP_RULES) == []

    @pytest.mark.parametrize("snippet,rule", [
        ("def f(x):\n    if torch.sum(x) > 0:\n        return x\n", "JS001"),
        ("def f(x):\n    while torch.any(x):\n        x = x * 0.5\n",
         "JS001"),
        ("def f(x):\n    return x if (x > 0).all() else -x\n", "JS001"),
        ("def f(x):\n    assert torch.isfinite(x).all()\n", "JS001"),
        ("def f(x):\n    return torch.sum(x).item()\n", "JS002"),
        ("def f(x):\n    return x.tolist()\n", "JS002"),
        ("def f(x):\n    return x.cpu()\n", "JS002"),
        ("def f(x):\n    return x.numpy()\n", "JS002"),
        ("def f(x):\n    return float(torch.sum(x))\n", "JS002"),
        ("def f(x):\n    return int(x.max())\n", "JS002"),
        ("def f(x):\n    return bool(torch.equal(x, x))\n", "JS002"),
        ("def f(x):\n    return np.asarray(torch.exp(x))\n", "JS002"),
        ("import time\ndef f(g):\n    t = time.perf_counter()\n    g()\n"
         "    return time.perf_counter() - t\n", "JS003"),
        ("def f(xs):\n    for x in xs:\n        print(x)\n", "JS004"),
        ("def f(xs):\n    for x in xs:\n        logging.info('%s', x)\n",
         "JS004"),
        ("def f():\n    return random.random()\n", "JS005"),
        ("def f():\n    return np.random.rand(3)\n", "JS005"),
        ("def f():\n    return np.random.default_rng()\n", "JS005"),
        ("def f(n):\n    return torch.rand(n)\n", "JS005"),
        ("def f(n):\n    return torch.randperm(n)\n", "JS005"),
        ("def f(p):\n    return torch.bernoulli(p)\n", "JS005"),
        ("def f(p):\n    return torch.multinomial(p, 2)\n", "JS005"),
        ("def f():\n    torch.manual_seed(0)\n", "JS005"),
    ])
    def test_bad_snippet_flagged(self, snippet, rule):
        findings = lint.lint_source(snippet, "snippet.py", rules=SWEEP_RULES)
        assert rule in rules_hit(findings)

    @pytest.mark.parametrize("snippet", [
        "def f(x):\n    return torch.where(torch.sum(x) > 0, x, -x)\n",
        "def f(n, x):\n    if n > 3:\n        return x\n    return -x\n",
        # fenced by torch.cuda.synchronize in the same function
        "import time\ndef f(g):\n    g()\n    torch.cuda.synchronize()\n"
        "    t = time.perf_counter()\n    g()\n    torch.cuda.synchronize()\n"
        "    return time.perf_counter() - t\n",
        # fenced inside a nested timing closure (a fence helper)
        "import time\ndef f(g):\n"
        "    def run():\n        with span('x'):\n"
        "            return fence(g())\n"
        "    run()\n    t = time.perf_counter()\n    run()\n"
        "    return time.perf_counter() - t\n",
        "def f(xs):\n    print('done', sum(xs))\n",
        "def f():\n    return np.random.default_rng(7).standard_normal(3)\n",
        "def f(n, g):\n    return torch.randint(0, 9, (n,), generator=g)\n",
        "def f(shape):\n    return math.prod(shape) if math.prod(shape) else 1\n",
        "def f(x):\n    if torch.is_grad_enabled() and x.requires_grad:\n"
        "        return x\n",
    ])
    def test_good_snippet_clean(self, snippet):
        assert lint.lint_source(snippet, "snippet.py", rules=SWEEP_RULES) == []

    def test_np_asarray_of_attribute_not_flagged(self):
        # np.asarray(st.indices) reads a field; only torch calls inside
        # the argument are flagged
        src = "def f(st):\n    return np.asarray(st.indices)\n"
        assert lint.lint_source(src, "s.py", rules=SWEEP_RULES) == []


class TestScopes:
    def test_sweep_layers_get_all_rules(self):
        for rel in ("planner/dispatch.py", "kernels/mttkrp.py",
                    "core/completion/als.py", "sparse/ccsr.py"):
            assert lint.scope_rules(f"port/repro_torch/{rel}") == SWEEP_RULES

    def test_data_layer_exempts_nondeterminism(self):
        rules = lint.scope_rules("port/repro_torch/data/streaming.py")
        assert "JS005" not in rules and "JS003" in rules

    def test_host_layers_keep_timing_and_rng(self):
        for rel in ("launch/complete.py", "serve/engine.py",
                    "runtime/fault_tolerance.py", "obs/profile.py"):
            assert lint.scope_rules(f"port/repro_torch/{rel}") == \
                {"JS003", "JS005"}

    @pytest.mark.parametrize("rel", ["obs/trace.py", "planner/tuner.py"])
    def test_sanctioned_timers_are_timing_exempt(self, rel):
        assert lint.scope_rules(f"port/repro_torch/{rel}") == {"JS005"}

    def test_files_outside_the_package(self):
        assert lint.scope_rules("chip_smoke.py") == {"JS003", "JS005"}


class TestSuppressions:
    def test_fixture(self):
        findings = lint.lint_source(BAD_SUPPRESS, "bad_suppress.py",
                                    rules={"JS003"})
        blocking = [f for f in findings if not f.suppressed]
        suppressed = [f for f in findings if f.suppressed]
        # reasonless + unknown-rule suppressions each yield a JS000, and the
        # reasonless one does NOT suppress its JS003
        assert {f.rule for f in blocking} == {"JS000", "JS003"}
        assert sum(f.rule == "JS000" for f in blocking) == 2
        assert sum(f.rule == "JS003" for f in blocking) >= 2
        assert {f.rule for f in suppressed} == {"JS003"}
        assert all(f.reason for f in suppressed)

    def test_comment_only_line_covers_next_line(self):
        src = ("import time\n"
               "def f(g):\n"
               "    # repro-lint: disable=JS003 -- host-only accounting\n"
               "    t = time.perf_counter()\n"
               "    return t\n")
        findings = lint.lint_source(src, "s.py", rules={"JS003"})
        assert findings and all(f.suppressed for f in findings)

    def test_js000_is_never_suppressible(self):
        src = "x = 1  # repro-lint: disable=JS000 -- please\n"
        findings = lint.lint_source(src, "s.py", rules=SWEEP_RULES)
        assert [f.rule for f in findings if not f.suppressed] == ["JS000"]

    def test_stale_suppression_is_advisory_js006(self):
        src = "x = 1  # repro-lint: disable=JS002 -- nothing fires here\n"
        findings = lint.lint_source(src, "s.py", rules=SWEEP_RULES)
        assert [(f.rule, f.advisory) for f in findings] == [("JS006", True)]

    def test_port_lints_clean_with_reasons(self):
        findings = lint.lint_paths([os.path.join(PORT, "repro_torch")])
        assert [f.format() for f in findings if not f.suppressed] == []
        suppressed = [f for f in findings if f.suppressed]
        assert suppressed and all(f.reason for f in suppressed)


# ---------------------------------------------------------------------------
# pass 2: planner contracts
# ---------------------------------------------------------------------------

class TestContractSweep:
    def test_grid_covers_all_families_and_orders(self):
        cases = contracts.iter_cases(device="cpu")
        fams = {c.family for c in cases}
        assert fams == set(contracts.FAMILIES) and len(fams) == 7
        orders = {len(c.st.shape) for c in cases if c.family == "tttp"}
        assert orders == {3, 4, 5}

    def test_grid_covers_distributed_variants(self):
        names = {c.name for c in contracts.iter_cases(orders=(3,),
                                                      device="cpu")}
        assert {"tttp/o3/rowsharded", "mttkrp/o3/rowsharded",
                "mttkrp/o3/model", "cg_matvec/o3/data",
                "cg_matvec/o3/model"} <= names

    def test_path_agreement_order3_clean(self):
        assert contracts.check_path_agreement(
            contracts.iter_cases(orders=(3,), device="cpu")) == []

    def test_fused_cg_path_is_certified_on_the_bucket_view(self):
        case = [c for c in contracts.iter_cases(orders=(3,), device="cpu")
                if c.name == "cg_matvec/o3/local"][0]
        assert case.st.row_buckets(0, case.config.block_rows) is not None
        sig = contracts.path_signature(case, "fused")
        assert sig == ("Tensor", (6, 4), "torch.float32", "cpu")

    def test_distributed_paths_run_on_the_collectives_standin(self):
        """No process group exists here: the stand-in gives each
        collective its output at the DistInfo's sizes, and the real
        functions come back afterwards."""
        import torch.distributed as dist
        from repro_torch.core import collectives as coll
        real = coll.all_gather
        case = [c for c in contracts.iter_cases(orders=(3,), device="cpu")
                if c.name == "mttkrp/o3/rowsharded"][0]
        assert contracts.path_signature(case, "rowsharded") == (
            "Tensor", (3, 4), "torch.float32", "cpu")
        assert coll.all_gather is real
        assert not dist.is_initialized()

    def test_corrupt_path_fails_sweep(self):
        contracts.set_corrupt("all_at_once")
        try:
            findings = contracts.check_path_agreement(
                contracts.iter_cases(orders=(3,), families=("mttkrp",),
                                     device="cpu"))
        finally:
            contracts.set_corrupt(None)
        assert findings and all(f.rule == "CT001" for f in findings)

    def test_cost_invariants_clean(self):
        assert contracts.check_cost_invariants(
            contracts.iter_cases(orders=(3, 4), device="cpu")) == []

    def test_cache_keys_clean(self):
        assert contracts.check_cache_keys("cpu") == []

    def test_cache_key_collision_detected(self, monkeypatch):
        from repro_torch.planner import plan as pplan
        real = pplan._signature

        def blind(expr, operands, *rest):   # ignores the operands' dtype
            ops = [o.astype(torch.float32) if hasattr(o, "astype") else o
                   for o in operands]
            return real(expr, ops, *rest)
        monkeypatch.setattr(pplan, "_signature", blind)
        findings = contracts.check_cache_keys("cpu")
        assert [f.rule for f in findings] == ["CT003"]
        assert "'dtype'" in findings[0].message

    def test_dist_sizes_distinguish_cache_keys(self):
        # same axis names, other sizes: the mesh-aliasing bug class
        from repro_torch.core.distributed import AxisCtx
        from repro_torch.planner import ir as pir
        from repro_torch.planner import plan as pplan
        from repro_torch.planner.config import PlannerConfig
        k2 = pplan._signature("ijk,jr,kr->ir", (), None,
                              AxisCtx(data="data", sizes=(("data", 2),)),
                              pir.DistInfo(2, 1, False), PlannerConfig())
        k4 = pplan._signature("ijk,jr,kr->ir", (), None,
                              AxisCtx(data="data", sizes=(("data", 4),)),
                              pir.DistInfo(4, 1, False), PlannerConfig())
        assert k2 != k4


class TestValidateHook:
    def _operands(self):
        st = contracts._make_sparse((6, 4, 8), torch.device("cpu"))
        return [st, torch.ones(4, 4), torch.ones(8, 4)]

    def test_validate_clean_plan(self):
        from repro_torch.planner.plan import clear_plan_cache, plan_contraction
        clear_plan_cache()
        plan = plan_contraction("ijk,jr,kr->ir", self._operands(),
                                validate=True)
        assert plan.path in plan.candidates
        clear_plan_cache()

    def test_validate_raises_on_corruption(self):
        from repro_torch.planner.plan import clear_plan_cache, plan_contraction
        clear_plan_cache()
        contracts.set_corrupt("kr_first")
        try:
            with pytest.raises(contracts.PlanContractError):
                plan_contraction("ijk,jr,kr->ir", self._operands(),
                                 validate=True)
        finally:
            contracts.set_corrupt(None)
            clear_plan_cache()

    def test_certify_candidates_direct(self):
        from repro_torch.core.distributed import LOCAL
        from repro_torch.planner import cost as pcost
        from repro_torch.planner import ir as pir
        from repro_torch.planner.config import default_config
        ops = self._operands()
        ir = pir.build_ir("ijk,jr,kr->ir", ops)
        contracts.certify_candidates(
            ir, [c.path for c in pcost.rank_paths(ir)], ops, LOCAL,
            default_config())

    def test_validate_spmd_certifies_a_new_plan(self):
        """``validate_spmd=True`` runs the sharding interpreter over every
        candidate of a distributed call before its plan is cached (a LOCAL
        call has nothing to certify)."""
        from repro_torch.core.distributed import AxisCtx
        from repro_torch.planner import cost as pcost
        from repro_torch.planner.plan import (clear_plan_cache,
                                              plan_contraction)
        clear_plan_cache()
        ctx = AxisCtx(data="data", sizes=(("data", 2),))
        plan = plan_contraction("ijk,jr,kr->ir", self._operands(), ctx=ctx,
                                validate_spmd=True)
        assert plan.path in pcost.candidate_paths(plan.ir)
        assert plan.ir.dist is not None and plan.ir.dist.data_size == 2


# ---------------------------------------------------------------------------
# pass 3: pytree registrations and static args
# ---------------------------------------------------------------------------

class TestPytrees:
    def test_port_registers_no_pytrees(self):
        src = os.path.join(PORT, "repro_torch")
        assert pytree_check.find_registrations(src) == []
        assert pytree_check.check_pytrees(src) == []

    def test_a_registration_is_reported(self, tmp_path):
        (tmp_path / "reg.py").write_text(
            "from torch.utils import _pytree as pytree\n"
            "pytree.register_pytree_node(int, None, None)\n"
            "@register_pytree_node_class\nclass A:\n    pass\n")
        findings = pytree_check.check_pytrees(str(tmp_path))
        assert [(f.rule, f.line) for f in findings] == [("PT001", 2),
                                                        ("PT001", 3)]

    def test_static_args_clean(self):
        assert pytree_check.check_static_args() == []

    def test_grids_vary_every_cache_key_type(self):
        names = {n for n, _, _ in pytree_check._static_type_grids()}
        assert names == {"planner.ir.DistInfo", "planner.config.PlannerConfig",
                         "core.distributed.AxisCtx", "planner.ir.OperandInfo",
                         "kernels.tile.KernelTile"}
        ctx = dict((n, v) for n, _, v in
                   pytree_check._static_type_grids())["core.distributed.AxisCtx"]
        assert "sizes" in {f for f, _ in ctx}

    @pytest.mark.parametrize("ignored", ["size", "groups"])
    def test_static_arg_aliasing_detected(self, monkeypatch, ignored):
        """An equality that ignores a meaningful field aliases two
        configurations (the mesh-aliasing bug's shape); AxisCtx's groups
        are rightly excluded, its sizes are not."""
        @dataclasses.dataclass(frozen=True, eq=False)
        class Lossy:
            name: str = "axis"
            size: int = 1

            def __eq__(self, other):
                return isinstance(other, Lossy) and self.name == other.name

            def __hash__(self):
                return hash(self.name)

        monkeypatch.setattr(
            pytree_check, "_static_type_grids",
            lambda: [("Lossy", Lossy(), [(ignored, Lossy(size=2))])])
        findings = pytree_check.check_static_args()
        assert findings and all(f.rule == "PT002" for f in findings)
        assert any("EQUAL" in f.message for f in findings)

    def test_pytree_module_flag_checks_one_more_module(self, tmp_path,
                                                       monkeypatch, capsys):
        """``--pytree-module MOD``: PT001 over the module's source and
        PT002 over the cache-key types it declares in CACHE_KEY_GRIDS."""
        (tmp_path / "extra_keys.py").write_text(
            "import dataclasses\n"
            "from torch.utils import _pytree as pytree\n"
            "def register():  # seen by the AST pass, never run\n"
            "    pytree.register_pytree_node(complex, None, None)\n"
            "@dataclasses.dataclass(frozen=True, eq=False)\n"
            "class Key:\n"
            "    name: str = 'a'\n"
            "    size: int = 1\n"
            "    def __eq__(self, other):\n"
            "        return self.name == other.name\n"
            "    def __hash__(self):\n"
            "        return hash(self.name)\n"
            "CACHE_KEY_GRIDS = [('Key', Key(), [('size', Key(size=2))])]\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        rules = sorted(f.rule for f in pytree_check.check_module(
            "extra_keys"))
        assert rules == ["PT001", "PT002"]
        assert cli_main(["--pytrees", "--root", REPO, "--pytree-module",
                         "extra_keys"]) == 1
        assert "[pytrees] 2 finding(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# dead-code report
# ---------------------------------------------------------------------------

class TestDeadcode:
    def test_port_has_no_unreachable_modules(self):
        rep = deadcode.analyze(REPO)
        assert rep.unreachable == set()
        assert "repro_torch.kernels.ops" in rep.product

    def test_orphan_module_detected(self, tmp_path):
        pkg = tmp_path / "port" / "repro_torch"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "used.py").write_text("import repro_torch\n")
        (pkg / "orphan.py").write_text("X = 1\n")
        (pkg / "tested.py").write_text("Y = 2\n")
        (tmp_path / "tests").mkdir()
        (tmp_path / "tests" / "test_x.py").write_text(
            "from repro_torch import tested\n")
        rep = deadcode.analyze(str(tmp_path), roots=("repro_torch.used",))
        assert rep.unreachable == {"repro_torch.orphan"}
        assert "repro_torch.used" in rep.product
        assert rep.test_only == {"repro_torch.tested": {"tests/test_x.py"}}

    def test_main_modules_are_entry_points(self):
        rep = deadcode.analyze(REPO)
        assert {"repro_torch.analysis.__main__",
                "repro_torch.analysis.spmd.__main__"} <= rep.product


# ---------------------------------------------------------------------------
# CLI / the gate
# ---------------------------------------------------------------------------

class TestCli:
    def test_lint_pytrees_deadcode_exit_zero(self, capsys):
        assert cli_main(["--lint", "--pytrees", "--deadcode", "--root", REPO,
                         "--strict-suppressions"]) == 0
        assert "OK" in capsys.readouterr().out

    def test_contracts_order3_exit_zero(self, capsys):
        assert cli_main(["--contracts", "--orders", "3", "--device", "cpu",
                         "--root", REPO]) == 0

    def test_corrupt_exits_nonzero(self, capsys):
        rc = cli_main(["--contracts", "--orders", "3", "--device", "cpu",
                       "--corrupt", "all_at_once", "--root", REPO])
        assert rc == 1
        assert "CT001" in capsys.readouterr().out
        assert contracts._CORRUPT_PATH is None   # hook reset afterwards

    def test_stale_suppression_blocks_only_when_strict(self, tmp_path,
                                                       capsys):
        pkg = tmp_path / "port" / "repro_torch" / "core"
        pkg.mkdir(parents=True)
        (pkg / "x.py").write_text(
            "y = 1  # repro-lint: disable=JS002 -- nothing fires\n")
        assert cli_main(["--lint", "--root", str(tmp_path)]) == 0
        assert cli_main(["--lint", "--root", str(tmp_path),
                         "--strict-suppressions"]) == 1
        assert "JS006" in capsys.readouterr().out

    def test_contracts_on_cuda_need_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            cli_main(["--contracts", "--root", REPO])
        assert e.value.code == 2

    def test_full_gate_exits_zero_and_the_tripwire_fails(self):
        """``python -m repro_torch.analysis --all --strict-suppressions
        --device cpu`` is the gate: 0 on the port, non-zero with
        ``--corrupt``."""
        env = dict(os.environ, PYTHONPATH=PORT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "repro_torch.analysis", "--all",
               "--strict-suppressions", "--device", "cpu"]
        out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip().endswith("OK")
        bad = subprocess.run(cmd + ["--corrupt", "fused"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert bad.returncode == 1 and "CT001" in bad.stdout
