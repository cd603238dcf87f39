"""Parity of the PyTorch port's planner and ``ctf`` facade
(``repro_torch.planner``, ``repro_torch.core.api``) with the JAX package's
on the CPU, on the same numpy operands, where the kernel wrappers take
their plain versions.

* every expression of ``tests/test_planner.py``'s PATTERNS under every
  candidate path against the reference's output on that path, at
  rtol = atol = 1e-4 in float32;
* candidate lists and the rate-independent cost terms (flops, memory and
  communication words) equal exactly, local and with a non-local
  ``DistInfo`` (static: no collective runs); the chosen path and the whole
  ranking equal under the reference's rates;
* random IRs (as ``tests/test_planner_properties.py``): every path against
  the dense einsum, values and gradients (autograd through the plain
  versions) at 1e-4;
* the plan cache, forced paths, autotuning, the refusals, the capture rule
  and the ``obs`` plan table;
* the rest of ``sparse/ops.py`` against the reference;
* the solvers' planner overrides against the reference's LOCAL runs (GGN
  in float64 at 1e-8, where no summation order can tip the line search).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as jctf
from repro import planner as jplanner
from repro.core import losses as jlosses
from repro.core.completion import als as jals
from repro.core.completion import ccd as jccd
from repro.core.completion import gauss_newton as jggn
from repro.core.completion import gcp as jgcp
from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.planner import cost as jcost
from repro.planner import ir as jir
from repro.sparse import ops as jsops

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

import repro_torch.core.api as ctf  # noqa: E402
from repro_torch import obs, planner  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.completion import als, ccd, gcp  # noqa: E402
from repro_torch.core.completion import gauss_newton as ggn  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.planner import cost as pcost  # noqa: E402
from repro_torch.planner import dispatch  # noqa: E402
from repro_torch.planner import ir as pir  # noqa: E402
from repro_torch.sparse import ops as sops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
REFERENCE_RATES = dict(flop=1.0e11, mem=1.0e10, comm=1.0e9)

# every supported family, order 2 through 5 (tests/test_planner.py)
PATTERNS = [
    ("ijk,jr,kr->ir", (13, 11, 7)),
    ("ijk,jr,kr->ri", (13, 11, 7)),
    ("ijk,ir,kr->jr", (13, 11, 7)),
    ("ijkl,jr,kr,lr->ir", (9, 8, 7, 6)),
    ("abcde,br,cr,dr,er->ar", (7, 6, 5, 4, 3)),
    ("ijkl,kr,lr->ijr", (9, 8, 7, 6)),
    ("ijkl,kr,lr->jir", (9, 8, 7, 6)),
    ("ijk,ir,jr,kr->r", (13, 11, 7)),
    ("ijk,kr->ijr", (13, 11, 7)),
    ("ijkl,jr->ilkr", (9, 8, 7, 6)),
    ("ijk,ir,jr,kr->ijk", (13, 11, 7)),
    ("ij,ir,jr->ij", (20, 15)),
    ("ijk,ir,kr->ijk", (13, 11, 7)),
    ("ijk,jr,kr,iy,jy,ky->ir", (13, 11, 7)),
    ("ijk,jr,kr,iy,jy,ky->ri", (13, 11, 7)),
    ("ijkl,jr,kr,lr,iy,jy,ky,ly->ir", (9, 8, 7, 6)),
    ("ijk->i", (13, 11, 7)),
    ("ijkl->il", (9, 8, 7, 6)),
    ("ijkl->li", (9, 8, 7, 6)),
    ("ijk->", (13, 11, 7)),
]


@pytest.fixture(autouse=True)
def _clean():
    planner.clear_plan_cache()
    pcost.reset_rates()
    yield
    pcost.reset_rates()
    obs.disable()
    obs.get_registry().reset()


def _coo(rng, shape, nnz, cap=None):
    """Padded COO arrays (duplicates possible), padding scattered."""
    cap = cap or nnz + 5
    idx = np.zeros((cap, len(shape)), np.int32)
    idx[:nnz] = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    vals = np.zeros(cap, np.float32)
    vals[:nnz] = rng.uniform(-1, 1, nnz)
    valid = np.arange(cap) < nnz
    perm = rng.permutation(cap)
    return idx[perm], vals[perm], valid[perm]


def _pair(arrays, shape, nnz):
    idx, vals, valid = arrays
    j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals),
                      jnp.asarray(valid), tuple(shape), nnz=nnz)
    t = SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                     torch.from_numpy(valid), tuple(shape), nnz)
    return j, t


def _operands(expr, shape, nnz=60, r=4, seed=0, shared_cg=True):
    """(reference operands, port operands) for a one-sparse expression;
    the Gram-matvec family reads the same factor matrix on both rank
    halves, as ``planned_cg_matvec`` builds it."""
    rng = np.random.default_rng(seed)
    lhs, _ = expr.split("->")
    terms = lhs.split(",")
    sizes = dict(zip(terms[0], shape))
    j, t = _pair(_coo(rng, shape, nnz), shape, nnz)
    mats = {}
    jops, tops = [j], [t]
    for term in terms[1:]:
        key = term if not shared_cg or term[1] != "y" or \
            term[0] + "r" not in terms else term[0] + "r"
        if key not in mats:
            a = rng.standard_normal((sizes[term[0]], r)).astype(np.float32)
            mats[key] = (jnp.asarray(a), torch.from_numpy(a))
        jops.append(mats[key][0])
        tops.append(mats[key][1])
    return jops, tops


def _np(x):
    if isinstance(x, SparseTensor):
        x = x.todense()
    if isinstance(x, JSparseTensor):
        x = x.todense()
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ---------------------------------------------------------------------------
# every pattern x every path against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr,shape", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_every_path_matches_reference(expr, shape):
    jops, tops = _operands(expr, shape)
    jplan = jctf.plan(expr, *jops)
    plan = ctf.plan(expr, *tops)
    assert set(plan.candidates) == set(jplan.candidates)
    for path in plan.candidates:
        got = ctf.einsum(expr, *tops, path=path)
        want = jctf.einsum(expr, *jops, path=path)
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"{expr} via {path}")


def test_sparse_operand_not_first_and_distinct_gram_factors():
    """The sparse operand may sit anywhere; a Gram-matvec einsum whose two
    rank halves read different matrices runs every path too (``fused``
    through the two-half schedule)."""
    jops, tops = _operands("ijk,jr,kr->ir", (13, 11, 7))
    expr = "jr,ijk,kr->ir"
    order = [1, 0, 2]
    for path in ctf.plan(expr, *[tops[i] for i in order]).candidates:
        got = ctf.einsum(expr, *[tops[i] for i in order], path=path)
        want = jctf.einsum(expr, *[jops[i] for i in order], path=path)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    expr = "ijk,jr,kr,iy,jy,ky->ir"
    jops, tops = _operands(expr, (13, 11, 7), shared_cg=False)
    assert tops[1] is not tops[5]
    for path in ctf.plan(expr, *tops).candidates:
        np.testing.assert_allclose(
            _np(ctf.einsum(expr, *tops, path=path)),
            _np(jctf.einsum(expr, *jops, path=path)), **TOL,
            err_msg=path)


# ---------------------------------------------------------------------------
# IR and cost model against the reference
# ---------------------------------------------------------------------------

def _cost_terms(c):
    return (c.path, c.flops, c.mem, c.comm)


def _check_costs(pir_, jir_):
    assert pir_.kind == jir_.kind
    cands = planner.candidate_paths(pir_)
    assert cands == jplanner.candidate_paths(jir_)
    for path in cands:
        assert _cost_terms(planner.estimate(pir_, path)) == \
            _cost_terms(jplanner.estimate(jir_, path)), path


@pytest.mark.parametrize("expr,shape", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_ir_candidates_and_cost_terms_equal_reference(expr, shape):
    jops, tops = _operands(expr, shape, nnz=50)
    pir_ = planner.build_ir(expr, tops)
    jir_ = jplanner.build_ir(expr, jops)
    assert (pir_.expr, pir_.out, pir_.sizes, pir_.keep_modes,
            pir_.rank_index, pir_.factor_modes, pir_.contract_mode,
            pir_.rank2_index, pir_.nnz) == \
        (jir_.expr, jir_.out, jir_.sizes, jir_.keep_modes, jir_.rank_index,
         jir_.factor_modes, jir_.contract_mode, jir_.rank2_index, jir_.nnz)
    _check_costs(pir_, jir_)
    # the ranking (and so the chosen path) under the reference's rates
    pcost.set_rates(**REFERENCE_RATES)
    assert [c.path for c in planner.rank_paths(pir_)] == \
        [c.path for c in jplanner.rank_paths(jir_)]
    assert ctf.plan(expr, *tops).path == jctf.plan(expr, *jops).path


@pytest.mark.parametrize("dist", [(2, 1, False), (1, 2, False), (4, 2, False),
                                  (2, 1, True)],
                         ids=["data2", "model2", "data4-model2", "rowsharded"])
def test_distributed_cost_terms_equal_reference(dist):
    """A non-local DistInfo is static: the IR, the candidates and the
    communication terms are the reference's (no collective runs)."""
    d = pir.DistInfo(*dist)
    jd = jir.DistInfo(*dist)
    exprs = ["ijk,jr,kr->ir", "ijk,ir,jr,kr->ijk"]
    if not d.rowsharded:
        exprs += ["ijk->i", "ijk,kr->ijr", "ijk,jr,kr,iy,jy,ky->ir"]
    for expr in exprs:
        jops, tops = _operands(expr, (12, 10, 8), nnz=50)
        if d.rowsharded:       # factor rows sharded: local rows per device
            jops = [jops[0]] + [a[: a.shape[0] // d.data_size]
                                for a in jops[1:]]
            tops = [tops[0]] + [a[: a.shape[0] // d.data_size]
                                for a in tops[1:]]
        pir_ = planner.build_ir(expr, tops, dist=d)
        jir_ = jplanner.build_ir(expr, jops, dist=jd)
        _check_costs(pir_, jir_)


def test_rates_are_the_h100_data_sheets_and_calibrate():
    assert (pcost.FLOP_RATE, pcost.MEM_RATE, pcost.COMM_RATE) == \
        (3.35e13, 8.4e11, 1.1e11)
    assert pcost.rates() == {"flop": 3.35e13, "mem": 8.4e11, "comm": 1.1e11}
    # seconds of a machine at 1e12 multiply-adds/s and 1e11 words/s
    samples = [(1e9, 1e8, 2e-3), (1e8, 1e9, 1.01e-2), (5e8, 5e8, 5.5e-3)]
    got = pcost.calibrate(samples)
    want = jcost.calibrate(samples)
    jcost.reset_rates()
    np.testing.assert_allclose([got["flop"], got["mem"]],
                               [want["flop"], want["mem"]], rtol=1e-12)
    np.testing.assert_allclose([got["flop"], got["mem"]], [1e12, 1e11],
                               rtol=1e-9)
    with pytest.raises(ValueError):
        pcost.set_rates(mem=0.0)


def _huge(shape, nnz):
    """A SparseTensor of ``nnz`` slots backed by one element (expanded):
    enough for planning, which reads metadata alone."""
    idx = torch.zeros(1, len(shape), dtype=torch.int32).expand(nnz, -1)
    vals = torch.zeros(1).expand(nnz)
    valid = torch.ones(1, dtype=torch.bool).expand(nnz)
    return SparseTensor(idx, vals, valid, shape, nnz)


def test_main_path_shape_plans_the_kernels():
    """At chip_smoke.py's main path (20000³, 80 M nonzeros, R = 10) the
    H100 rates rank the kernels' paths first: all-at-once MTTKRP and TTTP,
    the fused Gram matvec."""
    st = _huge((20000,) * 3, 80_000_000)
    f = torch.zeros(1, 10).expand(20000, -1)
    assert ctf.plan("ijk,jr,kr->ir", st, f, f).path == "all_at_once"
    assert ctf.plan("ijk,ir,jr,kr->ijk", st, f, f, f).path == "all_at_once"
    assert ctf.plan("ijk,jr,kr,iy,jy,ky->ir", st, f, f, f, f, f).path == \
        "fused"
    assert ctf.plan("ijk->i", st).path == "segment"


# ---------------------------------------------------------------------------
# random IRs: values and gradients against the dense einsum
# ---------------------------------------------------------------------------

KINDS = ("mttkrp", "partial_mttkrp", "tttp", "ttm", "reduce", "cg_matvec")
_LETTERS = "ijklmn"


def random_ir_case(kind, order, seed, r=4):
    """(expr, operands) of a random IR of one family (the generator of
    tests/test_planner_properties.py, on numpy), unique coordinates."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(rng.integers(4, 10)) for _ in range(order))
    nnz = int(rng.integers(10, 50))
    cells = int(np.prod(shape))
    lin = rng.choice(cells, size=min(nnz, cells), replace=False)
    idx = np.stack(np.unravel_index(lin, shape), 1).astype(np.int32)
    vals = rng.uniform(-1, 1, lin.shape[0]).astype(np.float32)
    st = SparseTensor.from_coo(idx, vals, shape,
                               cap=lin.shape[0] + int(rng.integers(0, 8)))
    s_term = _LETTERS[:order]

    def factor(d):
        return torch.from_numpy(
            rng.standard_normal((shape[d], r)).astype(np.float32))

    if kind == "mttkrp":
        mode = int(rng.integers(0, order))
        others = [d for d in range(order) if d != mode]
        out = s_term[mode] + "z"
        if rng.integers(0, 2):
            out = out[::-1]
        terms = [s_term] + [s_term[d] + "z" for d in others]
        ops = (st, *[factor(d) for d in others])
    elif kind == "partial_mttkrp":
        contracted = sorted(rng.choice(order, size=max(order - 2, 1),
                                       replace=False).tolist())
        kept = [d for d in range(order) if d not in contracted]
        out = "".join(s_term[d] for d in rng.permutation(kept)) + "z"
        terms = [s_term] + [s_term[d] + "z" for d in contracted]
        ops = (st, *[factor(d) for d in contracted])
    elif kind == "tttp":
        covered = sorted(rng.choice(order, size=int(rng.integers(1, order + 1)),
                                    replace=False).tolist())
        out = s_term
        terms = [s_term] + [s_term[d] + "z" for d in covered]
        ops = (st, *[factor(d) for d in covered])
    elif kind == "ttm":
        mode = int(rng.integers(0, order))
        kept = [d for d in range(order) if d != mode]
        out = "".join(s_term[d] for d in rng.permutation(kept)) + "z"
        terms = [s_term, s_term[mode] + "z"]
        ops = (st, factor(mode))
    elif kind == "reduce":
        k = int(rng.integers(0, order))
        out = "".join(s_term[d] for d in rng.permutation(
            rng.choice(order, size=k, replace=False)))
        terms = [s_term]
        ops = (st,)
    else:  # cg_matvec
        mode = int(rng.integers(0, order))
        others = [d for d in range(order) if d != mode]
        terms = ([s_term] + [s_term[d] + "z" for d in others]
                 + [s_term[mode] + "y"] + [s_term[d] + "y" for d in others])
        out = s_term[mode] + "z"
        fs = {d: factor(d) for d in others}
        ops = (st, *[fs[d] for d in others], factor(mode),
               *[fs[d] for d in others])
    return ",".join(terms) + "->" + out, ops


def _dense_args(ops):
    return [op.todense() if isinstance(op, SparseTensor) else op
            for op in ops]


CASES = [(k, o, s) for k in KINDS for o in (3, 4) for s in (11, 29, 47)]


@pytest.mark.parametrize("kind,order,seed", CASES,
                         ids=[f"{k}-o{o}-s{s}" for k, o, s in CASES])
def test_random_ir_every_path_matches_dense(kind, order, seed):
    expr, ops = random_ir_case(kind, order, seed)
    want = torch.einsum(expr, *_dense_args(ops))
    plan = ctf.plan(expr, *ops)
    assert plan.candidates
    for path in plan.candidates:
        np.testing.assert_allclose(_np(ctf.einsum(expr, *ops, path=path)),
                                   want.numpy(), **TOL,
                                   err_msg=f"{expr} via {path}")


GRAD_CASES = [(k, o) for k in KINDS for o in (3, 4)]


@pytest.mark.parametrize("kind,order", GRAD_CASES,
                         ids=[f"{k}-o{o}" for k, o in GRAD_CASES])
def test_random_ir_every_path_grads_match_dense(kind, order):
    """Gradients of sum(out²) in the sparse values and in every distinct
    dense operand (the Gram matvec reads its factors twice, as
    ``planned_cg_matvec`` passes them, so ``fused`` runs) by autograd
    through the plain versions, against the dense einsum's."""
    expr, ops = random_ir_case(kind, order, 11)
    st = ops[0]
    sparse_out = expr.split("->")[1] == expr.split(",")[0].split("->")[0]
    distinct = list({id(op): op for op in ops[1:]}.values())

    def grads(path):
        vals = st.values.detach().clone().requires_grad_()
        leaves = {id(op): op.detach().clone().requires_grad_()
                  for op in distinct}
        cur = st.with_values(vals)
        args = [cur] + [leaves[id(op)] for op in ops[1:]]
        if path is None:
            dense = torch.einsum(expr, cur.todense(), *args[1:])
            if sparse_out:                    # TTTP family: re-sample
                dense = dense[tuple(cur.indices[:, d].long()
                                    for d in range(cur.ndim))]
                dense = torch.where(cur.mask, dense, 0.0)
            loss = torch.sum(dense ** 2)
        else:
            out = ctf.einsum(expr, *args, path=path)
            out = out.masked_values() if isinstance(out, SparseTensor) \
                else out
            loss = torch.sum(out ** 2)
        loss.backward()
        return [vals.grad] + [leaves[id(op)].grad for op in distinct]

    want = grads(None)
    for path in ctf.plan(expr, *ops).candidates:
        for i, (g, w) in enumerate(zip(grads(path), want)):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), **TOL,
                err_msg=f"grad {i} of {expr} via {path}")


# ---------------------------------------------------------------------------
# plans: cache, forced paths, autotuning, refusals, capture, obs
# ---------------------------------------------------------------------------

def _mttkrp_ops(nnz=50, cap=None, seed=0):
    rng = np.random.default_rng(seed)
    _, t = _pair(_coo(rng, (13, 11, 7), nnz, cap), (13, 11, 7), nnz)
    v = torch.from_numpy(rng.standard_normal((11, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 4)).astype(np.float32))
    return t, v, w


def test_plan_cache_identity():
    st, v, w = _mttkrp_ops()
    p1 = ctf.plan("ijk,jr,kr->ir", st, v, w)
    assert ctf.plan("ijk, jr, kr -> ir", st, v, w) is p1
    assert planner.plan_cache_size() == 1
    # same metadata, other values: the same static signature
    st_b, v_b, w_b = _mttkrp_ops(seed=9)
    assert ctf.plan("ijk,jr,kr->ir", st_b, v_b, w_b) is p1
    # another nnz hint, dtype or device key: a fresh plan
    st_c, _, _ = _mttkrp_ops(nnz=40, cap=55)
    assert ctf.plan("ijk,jr,kr->ir", st_c, v, w) is not p1
    assert ctf.plan("ijk,jr,kr->ir", st, v.double(), w.double()) \
        is not p1
    assert planner.plan_cache_size() == 3


def test_forced_paths_and_bad_paths():
    st, v, w = _mttkrp_ops()
    plan = ctf.plan("ijk,jr,kr->ir", st, v, w, path="t_first")
    assert plan.path == "t_first" and plan.cost().path == "t_first"
    with pytest.raises(ValueError, match="not legal"):
        ctf.einsum("ijk,jr,kr->ir", st, v, w, path="not_a_path")
    with pytest.raises(ValueError):
        planner.build_ir("ijk,jr,kr->ir", (st, v))
    with pytest.raises(NotImplementedError):
        planner.build_ir("ijk,ijk->ijk", (st, st))


def test_autotune_pins_a_measured_winner():
    st, v, w = _mttkrp_ops(nnz=60)
    plan = planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                    autotune=True)
    assert plan.autotuned and plan.path in plan.candidates
    assert {p for p, _ in plan.timings} == set(plan.candidates)
    assert plan.path == min(plan.timings, key=lambda t: t[1])[0]
    assert planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                    autotune=True) is plan
    forced = planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                      path="t_first", autotune=True)
    assert forced.path == "t_first" and not forced.autotuned


@pytest.mark.parametrize("fault", [None, "missing-psum"])
def test_validate_spmd_certifies_before_caching(fault):
    """validate_spmd=True runs the sharding interpreter over every
    candidate of a distributed call before its plan is cached: a sound
    schedule plans as without it; under a planted missing psum it raises
    SP001 and caches nothing."""
    from repro_torch.analysis.spmd import sharding
    from repro_torch.core.distributed import AxisCtx
    st, v, w = _mttkrp_ops()
    ctx = AxisCtx(data="data", sizes=(("data", 2),))
    planner.clear_plan_cache()
    sharding.set_fault(fault)
    try:
        if fault is None:
            plan = planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                            ctx=ctx, validate_spmd=True)
            assert plan.path in plan.candidates
        else:
            with pytest.raises(sharding.SpmdContractError, match="SP001"):
                planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                         ctx=ctx, validate_spmd=True)
            assert planner.plan_cache_size() == 0
    finally:
        sharding.set_fault(None)


def test_validate_certifies_a_clean_plan_and_refuses_a_corrupted_path():
    """validate=True runs every candidate on the call's operands before the
    plan is cached: a clean call plans as without it, a corrupted path
    raises PlanContractError and caches nothing, and a cache hit skips the
    check (as the reference's)."""
    from repro_torch.analysis import contracts
    st, v, w = _mttkrp_ops()
    planner.clear_plan_cache()
    plan = planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                    validate=True)
    assert plan.path == planner.plan_contraction(
        "ijk,jr,kr->ir", (st, v, w)).path
    assert set(plan.candidates) == {"all_at_once", "bucketed", "t_first",
                                    "kr_first", "dense"}
    planner.clear_plan_cache()
    contracts.set_corrupt("t_first")
    try:
        with pytest.raises(contracts.PlanContractError, match="t_first"):
            planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                     validate=True)
        assert planner.plan_cache_size() == 0
        planner.plan_contraction("ijk,jr,kr->ir", (st, v, w))
        assert planner.plan_contraction("ijk,jr,kr->ir", (st, v, w),
                                        validate=True) is not None
    finally:
        contracts.set_corrupt(None)
        planner.clear_plan_cache()


class _Sharded:
    """A ctx of a 2 x 2 grid as the planner reads it (names and sizes)."""
    model = "model"

    def data_size(self):
        return 2

    def model_size(self):
        return 2


@pytest.mark.parametrize("kw", [dict(rowsharded=True),
                                dict(path="rowsharded"), dict(ctx="sharded")],
                         ids=["rowsharded", "path-rowsharded", "ctx"])
def test_distribution_options_plan_like_the_reference(kw):
    """The distribution options (refused before they were ported) plan as
    the reference plans them: ``rowsharded=True`` has the one candidate
    ``rowsharded``, the path alone is not legal without it, and a ctx's
    axis sizes reach the IR's DistInfo and the cost terms."""
    st, v, w = _mttkrp_ops()
    jst = JSparseTensor(jnp.asarray(st.indices.numpy()),
                        jnp.asarray(st.values.numpy()),
                        jnp.asarray(st.valid.numpy()), st.shape, st.nnz)
    ops, jops = (st, v, w), (jst, jnp.asarray(v.numpy()),
                             jnp.asarray(w.numpy()))
    if kw.get("path") == "rowsharded":
        with pytest.raises(ValueError, match="not legal"):
            planner.plan_contraction("ijk,jr,kr->ir", ops, **kw)
        with pytest.raises(ValueError, match="not legal"):
            jplanner.plan_contraction("ijk,jr,kr->ir", jops, **kw)
        return
    dist = (pir.DistInfo(1, 1, True) if kw.get("rowsharded")
            else pir.DistInfo(2, 2, False))
    if kw.get("ctx"):
        kw = dict(ctx=_Sharded())
    plan = planner.plan_contraction("ijk,jr,kr->ir", ops, **kw)
    assert plan.ir.dist == dist
    jdist = jir.DistInfo(dist.data_size, dist.model_size, dist.rowsharded)
    _check_costs(plan.ir, jir.build_ir("ijk,jr,kr->ir", jops, dist=jdist))
    assert plan.path == ("rowsharded" if dist.rowsharded else "all_at_once")


def test_classic_all_at_once_runs_the_bucketed_kernel(monkeypatch):
    """``all_at_once`` and ``bucketed`` both run the MTTKRP kernel's
    wrapper over the view at the config's granularity; the pairwise and
    dense paths do not. No fallback: the view is built when missing."""
    st, v, w = _mttkrp_ops()
    seen = []
    real = kops.mttkrp_bucketed

    def spy(buckets, factors, num_rows=None):
        seen.append(buckets.block_rows)
        return real(buckets, factors, num_rows)

    monkeypatch.setattr(kops, "mttkrp_bucketed", spy)
    cfg = planner.PlannerConfig(block_rows=16)
    for path in ("all_at_once", "bucketed", "t_first", "kr_first", "dense"):
        planner.planned_mttkrp(st, [None, v, w], 0, path=path, config=cfg)
    assert seen == [16, 16]
    assert (0, 16) in st._pattern_cache
    # the solver shims pin all_at_once, at their own granularity
    from repro_torch.core import distributed
    distributed.mttkrp_ctx(st, [None, v, w], 0, block_rows=8)
    assert seen == [16, 16, 8]


def test_pure_dense_delegates_lists_and_scalars():
    a = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_allclose(ctf.einsum("ij,jk->ik", a, a.T).numpy(),
                               (a @ a.T).numpy())
    got = ctf.einsum("i,i->", [1.0, 2.0], [3.0, 4.0], device="cpu")
    assert float(got) == 11.0 and got.device.type == "cpu"
    assert float(ctf.einsum(",->", 2.0, 3.5, device="cpu")) == 7.0


def test_greedy_einsum_matches_torch_einsum():
    rng = np.random.default_rng(3)
    expr = "abcde,br,cr,dr,er,ay,by,cy,dy,ey->ar"
    shapes = {"a": 5, "b": 4, "c": 3, "d": 4, "e": 3, "r": 3, "y": 3}
    ops = [torch.from_numpy(rng.standard_normal(
        [shapes[c] for c in t]).astype(np.float64))
        for t in expr.split("->")[0].split(",")]
    np.testing.assert_allclose(dispatch.greedy_einsum(expr, *ops).numpy(),
                               torch.einsum(expr, *ops).numpy(), rtol=1e-12)


def test_capture_replays_cached_plans_only(monkeypatch):
    st, v, w = _mttkrp_ops()
    plan = ctf.plan("ijk,jr,kr->ir", st, v, w)
    obs.enable()
    monkeypatch.setattr(trace, "capturing", lambda: True)
    assert ctf.plan("ijk,jr,kr->ir", st, v, w, autotune=True) is plan
    ctf.einsum("ijk,jr,kr->ir", st, v, w)
    assert obs.get_registry().summary()["plans"] == {}
    with pytest.raises(RuntimeError, match="eagerly first"):
        ctf.plan("ijk,jr,kr->ir", st, v, w, path="t_first")


def test_obs_records_predicted_against_measured():
    st, v, w = _mttkrp_ops()
    obs.enable()
    for _ in range(2):
        ctf.einsum("ijk,jr,kr->ir", st, v, w)
    ctf.einsum("ijk,jr,kr->ir", st, v, w, path="kr_first")
    summ = obs.get_registry().summary()
    assert summ["timings"]["planner/mttkrp/all_at_once"]["count"] == 2
    plans = summ["plans"]
    assert len(plans) == 2
    rec = plans["ijk,jr,kr->ir|all_at_once|m50|r4"]
    assert rec["measured"]["count"] == 2 and rec["kind"] == "mttkrp"
    ir = planner.build_ir("ijk,jr,kr->ir", (st, v, w))
    c = planner.estimate(ir, "all_at_once")
    assert rec["predicted"] == {"flops": c.flops, "mem": c.mem,
                                "comm": c.comm, "seconds": c.seconds}
    assert obs.last_root()["name"] == "planner/mttkrp/kr_first"


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def test_facade_constructors_and_tttp_surface():
    g = torch.Generator().manual_seed(1)
    T = ctf.random_sparse((12, 10, 8), 100, g)
    assert T.nnz == 100 and T.device.type == "cpu"
    U, V, W = (ctf.ones((12, 4), device="cpu"), ctf.ones((10, 4), "cpu"),
               ctf.ones((8, 4), "cpu"))
    np.testing.assert_allclose(ctf.TTTP(T, [U, V, W]).masked_values(),
                               4 * T.masked_values(), rtol=1e-6)
    np.testing.assert_allclose(ctf.TTTP(T, [U, None, W]).masked_values(),
                               4 * T.masked_values(), rtol=1e-6)
    np.testing.assert_allclose(
        ctf.TTTP(T, [torch.ones(12), torch.ones(10), torch.ones(8)])
        .masked_values(), T.masked_values(), rtol=1e-6)
    with pytest.raises(ValueError):
        ctf.TTTP(T, [None, None, None])
    E = ctf.tensor((5, 4), sp=True, cap=3, device="cpu")
    assert E.cap == 3 and E.nnz == 0 and E.shape == (5, 4)
    assert ctf.tensor((2, 3), device="cpu").shape == (2, 3)
    assert torch.equal(ctf.eye(3, device="cpu"), torch.eye(3))


# ---------------------------------------------------------------------------
# sparse/ops against the reference
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sparse_ops_match_reference():
    rng = np.random.default_rng(5)
    shape = (9, 8, 7)
    j, t = _pair(_coo(rng, shape, 120), shape, 120)
    fa = [rng.standard_normal((s, 3)).astype(np.float32) for s in shape]
    jf = [jnp.asarray(a) for a in fa]
    tf = [torch.from_numpy(a) for a in fa]
    for mode in range(3):
        np.testing.assert_allclose(
            sops.ttm_dense_output(t, tf[mode], mode).numpy(),
            np.asarray(jsops.ttm_dense_output(j, jf[mode], mode)), **TOL)
        hs, jhs = (sops.ttm_hypersparse(t, tf[mode], mode),
                   jsops.ttm_hypersparse(j, jf[mode], mode))
        assert int(hs.valid.sum()) == int(jhs.valid.sum())
        np.testing.assert_array_equal(hs.indices.numpy(),
                                      np.asarray(jhs.indices))
        np.testing.assert_allclose(hs.values.numpy(),
                                   np.asarray(jhs.values), **TOL)
        np.testing.assert_allclose(
            sops.ttm_fully_dense(t.todense(), tf[mode], mode).numpy(),
            np.asarray(jsops.ttm_fully_dense(j.todense(), jf[mode], mode)),
            **TOL)
        for port, ref in ((sops.mttkrp, jsops.mttkrp),
                          (sops.mttkrp_pairwise_t_first,
                           jsops.mttkrp_pairwise_t_first),
                          (sops.mttkrp_pairwise_kr_first,
                           jsops.mttkrp_pairwise_kr_first)):
            np.testing.assert_allclose(port(t, tf, mode).numpy(),
                                       np.asarray(ref(j, jf, mode)), **TOL,
                                       err_msg=f"{port.__name__} {mode}")
    j2, t2 = _pair(_coo(rng, shape, 80), shape, 80)
    u, ju = t.todense(), j.todense()
    s, js = sops.sparse_add_union(t, t2), jsops.sparse_add_union(j, j2)
    assert s.cap == js.cap and int(s.valid.sum()) == int(js.valid.sum())
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_allclose(s.values.numpy(), np.asarray(js.values),
                               **TOL)
    np.testing.assert_allclose(s.todense().numpy(),
                               (u + t2.todense()).numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(ju + j2.todense()),
                               s.todense().numpy(), **TOL)
    jmat, tmat = _pair(_coo(rng, (20, 15), 70), (20, 15), 70)
    a = rng.standard_normal((20, 4)).astype(np.float32)
    b = rng.standard_normal((15, 4)).astype(np.float32)
    np.testing.assert_allclose(
        sops.sddmm(tmat, torch.from_numpy(a), torch.from_numpy(b))
        .values.numpy(),
        np.asarray(jsops.sddmm(jmat, jnp.asarray(a), jnp.asarray(b)).values),
        **TOL)
    with pytest.raises(ValueError):
        sops.sddmm(t, tf[0], tf[1])


# ---------------------------------------------------------------------------
# the solvers' planner overrides against the reference
# ---------------------------------------------------------------------------

def _solver_problem(shape=(12, 10, 8), nnz=120, r=4, dtype=np.float32,
                    seed=0):
    rng = np.random.default_rng(seed)
    idx, vals, valid = _coo(rng, shape, nnz)
    j, t = _pair((idx, vals.astype(dtype), valid), shape, nnz)
    jo = j.with_values(jnp.ones_like(j.values) * j.mask)
    to = t.with_values(torch.ones_like(t.values) * t.mask)
    fa = [(rng.standard_normal((s, r)) * 0.3).astype(dtype) for s in shape]
    return (j, jo, [jnp.asarray(a) for a in fa], t, to,
            [torch.from_numpy(a) for a in fa])


def _close(got, want, tol=TOL, what=""):
    for d, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                   err_msg=f"{what} factor {d}")


@pytest.mark.slow
@pytest.mark.parametrize("h_slices", [1, 2])
def test_als_mttkrp_path_matches_reference(h_slices):
    """``mttkrp_path`` reaches both the right-hand side and the Gram
    matvec's MTTKRP half, the H-sliced schedule's too."""
    j, jo, jf, t, to, tf = _solver_problem()
    want = jals.als_sweep(j, jo, jf, lam=0.1, h_slices=h_slices,
                          mttkrp_path="t_first")
    got = als.als_sweep(t, to, tf, lam=0.1, h_slices=h_slices,
                        mttkrp_path="t_first")
    _close(got, want)
    _close(als.als_sweep(t, to, tf, lam=0.1), want, what="default")


def test_ccd_tttp_pairwise_matches_reference():
    j, _, jf, t, _, tf = _solver_problem()
    jrho = jccd.residual_values(j, jf)
    rho = ccd.residual_values(t, tf)
    jfs, jrho1 = jccd.ccd_sweep_tttp(j, jf, jrho, 0.1, tttp_path="pairwise")
    fs, rho1 = ccd.ccd_sweep_tttp(t, tf, rho, 0.1, tttp_path="pairwise")
    _close(fs, jfs)
    np.testing.assert_allclose(rho1.numpy(), np.asarray(jrho1), **TOL)


@pytest.mark.parametrize("path", ["all_at_once", "kr_first"])
def test_gcp_mttkrp_paths_match_reference(path):
    j, _, jf, t, _, tf = _solver_problem()
    want = jgcp.gcp_gradients(j, jf, jlosses.LOSSES["quadratic"], lam=0.1,
                              mttkrp_path=path)
    _close(gcp.gcp_gradients(t, tf, losses.LOSSES["quadratic"], lam=0.1,
                             mttkrp_path=path), want)
    _close(gcp.gcp_gradients(t, tf, losses.LOSSES["quadratic"], lam=0.1),
           want, what="default")


@pytest.mark.slow
def test_ggn_sliced_matvec_matches_reference_float64():
    with jax.enable_x64(True):
        j, _, jf, t, _, tf = _solver_problem((10, 9, 8), 200,
                                             dtype=np.float64, seed=3)
        kw = dict(cg_iters=6, joint_iters=4, precond_iters=3)
        loss = "poisson_log"
        jstate = jggn.ggn_sweep(j, jggn.ggn_init(jf, damping=1e-5),
                                jlosses.LOSSES[loss], 0.1,
                                matvec_path="sliced", **kw)
        state = ggn.ggn_sweep(t, ggn.ggn_init(tf, damping=1e-5),
                              losses.LOSSES[loss], 0.1,
                              matvec_path="sliced", **kw)
        _close(state.factors, jstate.factors, dict(rtol=1e-8, atol=1e-8))
        assert float(state.damping) == float(jstate.damping)
