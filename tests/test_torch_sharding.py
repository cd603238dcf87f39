"""The port's sharding interpreter (``repro_torch.analysis.spmd.sharding``,
SP001–SP004), after the JAX package's ``tests/test_spmd.py`` case for
case: the replication-state transfer units, the seeded-bug fixture through
``check_fixture`` and the CLI's ``--fixture/--expect``, the planner sweep
clean and tripped by both planted faults, ``certify_plan`` and
``plan_contraction(validate_spmd=True)``; then what the port adds: each
kernel leaf's rule equal to the op-by-op interpretation of its plain
version in ``kernels/ref.py``. Everything runs on the CPU (the plain
versions); the card runs the same sweep in ``chip_smoke.py`` phase 12."""
import itertools
import os
import sys

import pytest
import torch

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.spmd import sharding  # noqa: E402
from repro_torch.analysis.spmd.cli import check_fixture  # noqa: E402
from repro_torch.analysis.spmd.cli import main as spmd_main  # noqa: E402
from repro_torch.analysis.spmd.sharding import (  # noqa: E402
    PART, REP, ROWS, SpmdContractError, analyze_fn, axis_group, shard)
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.planner import cost as pcost  # noqa: E402
from repro_torch.sparse.ccsr import RowBlockBuckets  # noqa: E402

ENV1 = (("data", 2),)
V_SHARDED = ({"data": shard(0)},)
WANT_REP = {"data": "rep"}


def v():
    return (torch.linspace(0.5, 1.5, 8),)


def rules_of(findings):
    return {f.rule for f in findings}


def psum(x, axis):
    return coll.all_reduce(x, axis_group(axis))


# ---------------------------------------------------------------------------
# replication-state transfer units (analyze_fn)
# ---------------------------------------------------------------------------

class TestTransfer:
    def test_reduce_then_psum_is_clean(self):
        def f(x):
            return psum(torch.sum(x), "data")
        assert analyze_fn(f, v(), V_SHARDED, ENV1, expected=WANT_REP) == []

    def test_missing_psum_is_partial_sum_escape(self):
        def f(x):
            return torch.sum(x)
        fs = analyze_fn(f, v(), V_SHARDED, ENV1, expected=WANT_REP)
        assert rules_of(fs) == {"SP001"}

    def test_double_psum_is_over_reduction(self):
        def f(x):
            return psum(psum(torch.sum(x), "data"), "data")
        fs = analyze_fn(f, v(), V_SHARDED, ENV1, expected=WANT_REP)
        assert "SP002" in rules_of(fs) and "SP001" not in rules_of(fs)

    def test_wrong_axis_psum_flags_both_sides(self):
        """An all-reduce over the WRONG axis: the reduced axis stays a
        partial sum (SP001) while the named axis gets a redundant psum
        (SP002); the all-reduce over the model group leaves the data
        axis's state alone."""
        env = (("data", 2), ("model", 2))
        states = ({"data": shard(0), "model": REP},)

        def f(x):
            return psum(torch.sum(x), "model")
        fs = analyze_fn(f, v(), states, env,
                        expected={"data": "rep", "model": "rep"})
        assert rules_of(fs) == {"SP001", "SP002"}

    def test_sharded_escape_when_replication_expected(self):
        def f(x):
            return x * 2.0
        fs = analyze_fn(f, v(), V_SHARDED, ENV1, expected=WANT_REP)
        assert rules_of(fs) == {"SP003"}

    def test_all_gather_discharges_shard(self):
        def f(x):
            return coll.all_gather(x, axis_group("data"))
        assert analyze_fn(f, v(), V_SHARDED, ENV1, expected=WANT_REP) == []

    def test_gather_into_rowsharded_factor_flags_sp004(self):
        """Global row indexing into a ROWS-sharded factor without an
        all-gather resolves against the local shard: SP004."""
        args = (torch.ones(8, 4), torch.tensor([0, 3, 5, 7, 1, 2]))
        states = ({"data": shard(0, ROWS)}, {"data": REP})

        def f(factor, rows):
            return psum(torch.sum(factor[rows], dim=0), "data")
        fs = analyze_fn(f, args, states, ENV1, expected=WANT_REP)
        assert "SP004" in rules_of(fs)

    def test_gather_into_local_nnz_shard_is_legal(self):
        """The same gather into an UNTAGGED shard (owner-aligned nonzeros,
        e.g. a sort permutation) is a local move, not a finding."""
        args = (torch.linspace(0, 1, 8), torch.arange(7, -1, -1))
        states = ({"data": shard(0)}, {"data": shard(0)})

        def f(vals, perm):
            return vals[perm]
        assert analyze_fn(f, args, states, ENV1,
                          expected={"data": "shard"}) == []

    def test_raising_fn_is_sp000(self):
        def f(x):
            raise RuntimeError("boom")
        fs = analyze_fn(f, v(), V_SHARDED, ENV1)
        assert rules_of(fs) == {"SP000"}

    def test_aten_op_without_a_rule_is_sp000_naming_it(self):
        """The port's departure: an operation the interpreter has no rule
        for is a finding, never a silent ``rep``."""
        def f(x):
            return torch.fft.fft(x)
        fs = analyze_fn(f, v(), V_SHARDED, ENV1)
        assert rules_of(fs) == {"SP000"}
        assert "aten._fft" in fs[0].message


# ---------------------------------------------------------------------------
# the seeded-bug fixture: exactly ONE planted defect
# ---------------------------------------------------------------------------

# a data-sharded segment sum with NO all-reduce: each rank returns only its
# local rows' contribution, a partial-sum escape (the reference's
# tests/analysis_fixtures/spmd_missing_psum.py)
MISSING_PSUM = '''\
import torch

AXIS_ENV = (("data", 2),)
ARGS = (
    torch.linspace(0.5, 1.5, 16),          # nonzero values (sharded)
    torch.arange(16) % 8,                  # mode-0 rows (sharded)
    torch.ones(8, 4),                      # factor (replicated)
)
IN_STATES = (
    {"data": ("shard", 0)},
    {"data": ("shard", 0)},
    {"data": ("rep",)},
)
EXPECTED = {"data": "rep"}   # an MTTKRP row block must be fully reduced


def run(values, rows, factor):
    contrib = values[:, None] * factor[rows]
    return torch.zeros(8, 4).index_add_(0, rows, contrib)
    # BUG: missing coll.all_reduce(out, axis_group("data"))
'''


@pytest.fixture
def missing_psum(tmp_path):
    p = tmp_path / "spmd_missing_psum.py"
    p.write_text(MISSING_PSUM)
    return str(p)


class TestFixtures:
    def test_fixture_reports_exactly_its_planted_rule(self, missing_psum):
        assert rules_of(check_fixture(missing_psum)) == {"SP001"}

    def test_cli_expect_contract(self, missing_psum):
        assert spmd_main(["--fixture", missing_psum, "--expect",
                          "SP001"]) == 0
        assert spmd_main(["--fixture", missing_psum, "--expect",
                          "SP999"]) == 1


# ---------------------------------------------------------------------------
# the planner sweep, the planted faults, certify_plan, validate_spmd
# ---------------------------------------------------------------------------

def _distributed(families=("mttkrp", "tttp")):
    return [c for c in contracts.iter_cases((3,), device="cpu")
            if c.ir.dist is not None and c.family in families]


class TestShardingSweep:
    def test_order3_sweep_is_clean(self):
        assert sharding.check_cases(orders=(3,), device="cpu") == []

    @pytest.mark.parametrize("fault,rule", [
        ("missing-psum", "SP001"),
        ("double-psum", "SP002"),
    ])
    def test_planted_fault_trips_the_sweep(self, fault, rule):
        sharding.set_fault(fault)
        try:
            fs = sharding.check_cases(cases=_distributed())
        finally:
            sharding.set_fault(None)
        assert fs, f"fault {fault!r} produced no findings"
        assert rules_of(fs) == {rule}

    @pytest.mark.parametrize("fault,rule", [
        ("missing-psum", "SP001"),
        ("double-psum", "SP002"),
    ])
    def test_cli_fault_exits_one(self, fault, rule, capsys):
        assert spmd_main(["--sharding", "--device", "cpu", "--orders", "3",
                          "--fault", fault]) == 1
        out = capsys.readouterr().out
        assert f": {rule} " in out and "FAILED" in out

    def test_certify_plan_distributed(self):
        case = next(c for c in _distributed(("mttkrp",))
                    if c.ir.dist.data_size > 1 and not c.ir.dist.rowsharded)
        paths = pcost.candidate_paths(case.ir)
        operands = [case.st, *case.denses]
        sharding.certify_plan(case.ir, paths, operands, case.ctx,
                              case.config)      # sound: no raise
        sharding.set_fault("missing-psum")
        try:
            with pytest.raises(SpmdContractError, match="SP001"):
                sharding.certify_plan(case.ir, paths, operands, case.ctx,
                                      case.config)
        finally:
            sharding.set_fault(None)

    @pytest.mark.parametrize("dist", ["local", "data", "model"])
    def test_plan_contraction_validate_spmd_wiring(self, dist):
        from repro_torch.core.distributed import LOCAL, AxisCtx
        from repro_torch.core.sparse_tensor import SparseTensor
        from repro_torch.planner.plan import (clear_plan_cache,
                                              plan_contraction)
        g = torch.Generator().manual_seed(0)
        st = SparseTensor.random(g, (12, 10, 8), 40, cap=48)
        r = 4
        ctx = {"local": LOCAL,
               "data": AxisCtx(data="data", sizes=(("data", 2),)),
               "model": AxisCtx(model="model", sizes=(("model", 2),))}[dist]
        factors = [torch.linspace(-1, 1, d * r).reshape(d, r)
                   for d in st.shape]
        clear_plan_cache()
        plan = plan_contraction("ijk,jr,kr->ir", [st] + factors[1:],
                                ctx=ctx, validate_spmd=True)
        assert plan.path in pcost.candidate_paths(plan.ir)


# ---------------------------------------------------------------------------
# the kernel leaves: each rule equals its plain version, op by op
# ---------------------------------------------------------------------------

FACTOR_STATES = [REP, PART, shard(0), shard(1), shard(None), shard(0, ROWS)]


def _plain(fn, inputs, states):
    interp = sharding._Interp(("data",), "plain")
    for t, s in zip(inputs, states):
        interp.put(t, {"data": s})
    with interp:
        out = fn()
    return interp.get(out)["data"], rules_of(interp.findings)


def _leaf(rule, inputs, states):
    interp = sharding._Interp(("data",), "leaf")
    for t, s in zip(inputs, states):
        interp.put(t, {"data": s})
    return rule(interp)["data"], rules_of(interp.findings)


def _tensor_and_factors():
    g = torch.Generator().manual_seed(0)
    shape, r = (8, 6, 5), 4
    idx = torch.stack([torch.randint(0, s, (24,), generator=g)
                       for s in shape], 1)
    return (shape, r, torch.rand(24, generator=g), idx,
            torch.rand(24, generator=g) > 0.2,
            [torch.rand(s, r, generator=g) for s in shape])


def test_tttp_leaf_equals_its_plain_version():
    """``kernels.ops._tttp``'s rule against ``kref.tttp_ref`` interpreted
    operation by operation: every state of the values, indices, valid and
    two factors (the third absent), the SP004 findings too."""
    _, _, vals, idx, valid, fs = _tensor_and_factors()
    n = 0
    for st in itertools.product([REP, PART, shard(0)],
                                [REP, shard(0), shard(1)],
                                [REP, shard(0)], FACTOR_STATES,
                                [REP, shard(1), shard(0, ROWS)]):
        f = [fs[0].clone(), fs[1].clone(), None]
        ins = [vals.clone(), idx.clone(), valid.clone(), f[0], f[1]]
        want = _plain(lambda: kref.tttp_ref(ins[0], ins[1], ins[2], f),
                      ins, st)
        got = _leaf(lambda it: sharding._tttp_rule(it, ins[0], ins[1],
                                                   ins[2], f), ins, st)
        assert got == want, st
        n += 1
    assert n == 324


@pytest.mark.parametrize("fused", [False, True], ids=["mttkrp", "cg_matvec"])
def test_bucketed_leaf_equals_its_plain_version(fused):
    """``mttkrp_bucketed``'s and ``cg_matvec_bucketed``'s rule against
    ``kref.mttkrp_bucketed_ref`` / ``cg_matvec_bucketed_ref`` interpreted
    operation by operation, over the bucket arrays' states (``valid``
    shares ``local_row``'s: a bucket view makes them together), the
    non-target factors' and x's."""
    shape, r, _, _, _, fs = _tensor_and_factors()
    g = torch.Generator().manual_seed(1)
    nb, c, br = 3, 10, 4
    bv = torch.rand(nb, c, generator=g)
    bi = torch.stack([torch.randint(0, s, (nb, c), generator=g)
                      for s in shape], 2)
    bl = torch.randint(0, br, (nb, c), generator=g)
    x = torch.rand(nb * br, r, generator=g)
    arrays = [REP, shard(0), shard(1), shard(None)]
    n = 0
    for st in itertools.product([REP, PART, shard(1)], arrays,
                                arrays + [shard(2)], FACTOR_STATES,
                                [REP, shard(1)],
                                [REP, shard(1), shard(0, ROWS), PART]):
        ins = [bv.clone(), bl.clone(), bi.clone(), fs[1].clone(),
               fs[2].clone(), x.clone(), torch.ones(nb, c, dtype=torch.bool)]
        states = list(st) + [st[1]]
        buckets = RowBlockBuckets(ins[0], ins[2], ins[1], ins[6], 0, br,
                                  shape)
        fl = [None, ins[3], ins[4]]
        if fused:
            want = _plain(lambda: kref.cg_matvec_bucketed_ref(
                ins[0], ins[2], ins[1], fl, ins[5], 0, br), ins, states)
        else:
            want = _plain(lambda: kref.mttkrp_bucketed_ref(
                ins[0], ins[2], ins[1], fl, 0, br), ins, states)
        got = _leaf(lambda it: sharding._bucket_rule(
            it, buckets, fl, ins[5] if fused else None), ins, states)
        assert got == want, st
        n += 1
    assert n == 3 * 4 * 5 * 6 * 2 * 4


# ---------------------------------------------------------------------------
# one certification at a time, and nothing from other threads
# ---------------------------------------------------------------------------

def test_other_threads_pass_through_a_running_certification():
    """While a thread runs the interpreter, the kernel leaves and the
    stand-in collectives it binds are module attributes; another thread's
    kernel call runs as it would unbound (its result gets no state, the
    certifying interpreter is not suspended) and its collective reaches the
    real one (no process group here, so it raises)."""
    import threading
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import ops as kops
    g = torch.Generator().manual_seed(0)
    st = SparseTensor.random(g, (12, 10, 8), 40, cap=48)
    fs = [None] + [torch.rand(d, 4, generator=g) for d in st.shape[1:]]
    bk = st.row_buckets(0, 4)
    want = kops.mttkrp_bucketed(bk, fs)
    interp = sharding._Interp(("data",), "main")
    seen = {}

    def other():
        seen["out"] = kops.mttkrp_bucketed(bk, fs)
        seen["suspended"] = interp.suspended
        try:
            coll.all_reduce(torch.ones(2), None)
        except Exception as e:          # the real collective, no group
            seen["collective"] = type(e).__name__
        else:
            seen["collective"] = "stand-in"

    with sharding._bound(interp):
        mine = coll.all_reduce(torch.ones(2), None)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert torch.equal(mine, torch.ones(2))     # the stand-in here
    assert torch.equal(seen["out"], want)
    assert seen["suspended"] == 0 and seen["collective"] != "stand-in"
    assert seen["out"] not in interp.states
    assert kops.mttkrp_bucketed.__name__ == "mttkrp_bucketed"
    assert not hasattr(kops.mttkrp_bucketed, "__wrapped__")
