"""Pass 2 — the planner contract sweep over the port's planner.

The planner's worth (paper §5.3) rests on structural contracts that tests
otherwise hold only case by case:

1. **All candidate paths agree** (``CT001``): every legal execution path of
   a :class:`~repro_torch.planner.ir.ContractionIR` computes the same
   einsum, so it must give the same output structure (a tensor or a
   ``SparseTensor``), shape, dtype and device. Torch has no abstract
   evaluation of a whole program (the JAX package traces ``make_jaxpr``),
   so each path RUNS, on the sweep's tiny concrete operands (8 nonzeros),
   on the device given: on the card the kernel routes themselves are
   certified. Distributed variants create no process group:
   :func:`collective_standin` binds a stand-in for ``core/collectives.py``
   (the one place the port makes collectives) whose collectives return
   their outputs at the ``DistInfo``'s sizes (an all-gather of P blocks, a
   reduce-scatter's one block), with the ctx's groups stand-ins of those
   sizes.
2. **Cost-model invariants** (``CT002``), over the port's
   ``planner/cost.py``: flops/mem/comm finite and nonnegative for every
   (IR, path); ``comm == 0`` for LOCAL IRs; the densified fallback's flops
   bound every sparse path's at sub-saturation density; estimates are
   deterministic.
3. **Cache-key hygiene** (``CT003``), over the port's plan signature
   (``planner.plan._signature``): hashable, deterministic, and distinct
   across a grid of signature-relevant variations (shape, cap, nnz, a
   bf16 dtype, nnz_rows, forced path, ``AxisCtx`` and ``DistInfo`` sizes,
   ``PlannerConfig``, and the device when the sweep runs on the card).

:func:`iter_cases` covers the 7 IR families (DENSE, REDUCE, TTTP, TTM,
classic MTTKRP, partial MTTKRP, CG_MATVEC) at orders 3–5, local plus every
``DistInfo`` variant the executor supports (data-sharded, model-sharded,
row-sharded). The same certificate runs online through
``plan_contraction(validate=True)`` (:func:`certify_candidates`), which
runs every candidate of that call on the call's own operands before a new
plan enters the cache: one execution per candidate, as ``autotune=True``
pays.

:func:`set_corrupt` (``--corrupt PATH`` in the CLI) distorts one path's
output, which must make the sweep fail: the tripwire that shows the
checker would catch a real disagreement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.lint import Finding  # shared report record

_LETTERS = "ijklm"
_EXTENTS = {3: (6, 4, 8), 4: (6, 4, 8, 4), 5: (6, 4, 8, 4, 6)}
_RANK = 4
_NNZ = 8

FAMILIES = ("dense", "reduce", "tttp", "ttm", "mttkrp", "mttkrp_partial",
            "cg_matvec")

# the deliberate-corruption hook (checker self-test / CI tripwire): when set
# to a path name, that path's output gains a leading axis, which MUST make
# the sweep fail
_CORRUPT_PATH: Optional[str] = None


def set_corrupt(path: Optional[str]) -> None:
    global _CORRUPT_PATH
    _CORRUPT_PATH = path


class PlanContractError(RuntimeError):
    """A candidate path's output disagrees with its siblings'."""


@dataclasses.dataclass
class Case:
    """One (expression, operands, distribution) point of the sweep grid."""
    name: str
    family: str
    expr: str
    ir: object                 # ContractionIR
    st: object                 # SparseTensor (concrete, tiny) or None
    denses: Tuple              # dense operands in operand order
    ctx: object                # AxisCtx (groups: stand-ins of their sizes)
    config: object             # PlannerConfig


# ---------------------------------------------------------------------------
# the collectives stand-in (no process group)
# ---------------------------------------------------------------------------

class StandInGroup:
    """A process group of ``n`` ranks as far as the stand-in collectives
    read one: its size, and the mesh axis it spans (``axis``, which the
    sharding interpreter reads to know what a collective reduces)."""

    def __init__(self, n: int, axis: Optional[str] = None):
        self.n = n
        self.axis = axis

    def size(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"StandInGroup({self.n}, axis={self.axis!r})"


class _Done:
    """A finished all-gather (``core.collectives.Pending``'s interface)."""

    def __init__(self, out: torch.Tensor):
        self._out = out

    def wait(self) -> torch.Tensor:
        return self._out


def _group_size(group) -> int:
    return group.size() if group is not None else 1


def _all_reduce(x, group=None, op="sum"):
    return x.clone()


def _all_gather(x, group=None, async_op=False):
    out = torch.cat([x] * _group_size(group), dim=0)
    return _Done(out) if async_op else out


def _reduce_scatter(x, group=None):
    p = _group_size(group)
    if x.shape[0] % p:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not a "
                         f"multiple of the group size ({p})")
    return x[:x.shape[0] // p].clone()


_STANDINS = {
    "all_reduce": _all_reduce,
    "all_reduce_ints": lambda values, group=None, op="sum": list(values),
    "all_gather": _all_gather,
    "reduce_scatter": _reduce_scatter,
    "broadcast": lambda x, src=0, group=None: x.clone(),
    "exchange": lambda sends, peer, group=None: [t.clone() for t in sends],
    "barrier": lambda group=None: None,
}


# held while module attributes are rebound for one thread's check (the
# stand-in collectives here, the sharding interpreter's kernel leaves):
# two checks at once would restore each other's bindings out of order
STANDIN_LOCK = threading.RLock()


def _on_thread(owner: int, standin: Callable, real: Callable) -> Callable:
    """``standin`` on thread ``owner``, ``real`` on every other thread."""
    def call(*args, **kwargs):
        fn = standin if threading.get_ident() == owner else real
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def collective_standin(wrap: Optional[Callable] = None) -> Iterator[None]:
    """Bind stand-ins for every collective of ``core/collectives.py`` on the
    calling thread: each returns its output at the shapes its group's size
    gives, and no process group is needed or touched. Other threads reach
    the real collectives meanwhile, and a second check waits for the first
    (``STANDIN_LOCK``). ``wrap(name, fn)``, if given, returns what is bound
    in place of stand-in ``fn`` (the sharding interpreter observes each
    collective this way). The real functions come back on exit."""
    from repro_torch.core import collectives as coll
    owner = threading.get_ident()
    with STANDIN_LOCK:
        saved = {name: getattr(coll, name) for name in _STANDINS}
        try:
            for name, fn in _STANDINS.items():
                setattr(coll, name, _on_thread(
                    owner, fn if wrap is None else wrap(name, fn),
                    saved[name]))
            yield
        finally:
            for name, fn in saved.items():
                setattr(coll, name, fn)


def standin_ctx(dist):
    """The ``AxisCtx`` of a ``DistInfo`` under the stand-in: named axes of
    its sizes, rank 0's coordinates, stand-in groups of those sizes."""
    from repro_torch.core.distributed import LOCAL, AxisCtx
    if dist is None:
        return LOCAL
    data = dist.data_size > 1 or dist.rowsharded
    model = dist.model_size > 1
    sizes = ((("data", max(dist.data_size, 1)),) if data else ()) \
        + ((("model", dist.model_size),) if model else ())
    return AxisCtx(data="data" if data else None,
                   model="model" if model else None, sizes=sizes,
                   coords=tuple((n, 0) for n, _ in sizes),
                   groups=(StandInGroup(dist.data_size, "data")
                           if data else None,
                           StandInGroup(dist.model_size, "model")
                           if model else None))


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------

def _make_sparse(shape, device, nnz=_NNZ, dense_dim=None,
                 dtype=torch.float32):
    """Deterministic tiny sparse tensor (no RNG: the sweep must be
    bit-reproducible across runs and machines)."""
    from repro_torch.core.sparse_tensor import SparseTensor
    idx = torch.stack([(torch.arange(nnz) * (d + 3)) % s
                       for d, s in enumerate(shape)], dim=1)
    n = nnz if dense_dim is None else nnz * dense_dim
    vals = torch.linspace(0.5, 1.5, n, dtype=dtype)
    if dense_dim is not None:
        vals = vals.reshape(nnz, dense_dim)
    return SparseTensor.from_coo(idx, vals, shape, device=device)


def _make_factor(rows, cols, seed, device, dtype=torch.float32):
    return (torch.linspace(-1.0, 1.0, rows * cols, dtype=dtype)
            .reshape(rows, cols) + 0.01 * seed).to(device)


def _dist_variants(family: str):
    """(variant name, DistInfo fields) pairs legal for this family."""
    base = [("local", None)]
    data = ("data", (2, 1, False))
    model = ("model", (1, 2, False))
    rowsh = ("rowsharded", (2, 1, True))
    return {
        "dense": base,
        "reduce": base + [data],
        "tttp": base + [data, model, rowsh],
        "ttm": base + [data],
        "mttkrp": base + [data, model, rowsh],
        "mttkrp_partial": base + [data],
        "cg_matvec": base + [data, model],
    }[family]


def _family_exprs(family: str, order: int) -> List[str]:
    s = _LETTERS[:order]
    if family == "dense":
        return ["ab,bc->ac"] if order == 3 else []
    if family == "reduce":
        return [f"{s}->{s[-1]}{s[0]}"]
    if family == "tttp":
        facs = ",".join(f"{c}r" for c in s)
        return [f"{s},{facs}->{s}"]
    if family == "ttm":
        out = [f"{s},{s[-1]}r->{s[:-1]}r"]
        if order == 3:
            out.append(f"{s},{s[-1]}r->r{s[:-1]}")   # permuted output
        return out
    if family == "mttkrp":
        facs = ",".join(f"{c}r" for c in s[1:])
        out = [f"{s},{facs}->{s[0]}r"]
        if order == 3:
            out.append(f"{s},{facs}->r{s[0]}")       # permuted output
        return out
    if family == "mttkrp_partial":
        if order < 4:
            return []                    # order-3 partial degenerates to TTM
        kept, contracted = s[:2], s[2:]
        facs = ",".join(f"{c}r" for c in contracted)
        return [f"{s},{facs}->{kept}r"]
    if family == "cg_matvec":
        r_facs = ",".join(f"{c}r" for c in s[1:])
        y_facs = ",".join(f"{c}y" for c in s)
        return [f"{s},{r_facs},{y_facs}->{s[0]}r"]
    raise ValueError(family)


def _build_case(family: str, expr: str, order: int, variant: str,
                dist_fields, device) -> Case:
    from repro_torch.planner import ir as pir
    from repro_torch.planner.config import default_config

    dist = None if dist_fields is None else pir.DistInfo(*dist_fields)
    ctx = standin_ctx(dist)
    lhs, _ = expr.split("->")
    terms = lhs.split(",")
    if family == "dense":
        sizes = {"a": 3, "b": 4, "c": 5}
        denses = tuple(_make_factor(sizes[t[0]], sizes[t[1]], i, device)
                       for i, t in enumerate(terms))
        ir = pir.build_ir(expr, denses, dist=dist)
        return Case(f"{family}/{variant}", family, expr, ir, None, denses,
                    ctx, default_config())

    shape = _EXTENTS[order]
    sizes = dict(zip(_LETTERS[:order], shape))
    rank = _RANK // dist.model_size if dist is not None else _RANK
    sizes["r"] = sizes["y"] = rank
    st = _make_sparse(shape, device)
    row_div = dist.data_size if (dist is not None and dist.rowsharded) else 1

    # one factor per sparse mode, shared wherever that mode appears (the
    # fused kernel's legality depends on the two halves sharing factors)
    per_mode: Dict[str, torch.Tensor] = {}
    denses_l: List = []
    for i, t in enumerate(terms[1:]):
        mode_c = t[0]
        if family == "cg_matvec" and t == f"{mode_c}y" and mode_c != lhs[0]:
            arr = per_mode[mode_c]                    # share with the r half
        else:
            arr = _make_factor(sizes[mode_c] // row_div, sizes[t[1]], i,
                               device)
            per_mode.setdefault(mode_c, arr)
        denses_l.append(arr)
    ir = pir.build_ir(expr, [st] + denses_l, dist=dist)
    perm = "/perm" if expr.split("->")[1][0] == "r" else ""
    return Case(f"{family}/o{order}/{variant}{perm}", family, expr, ir, st,
                tuple(denses_l), ctx, default_config())


def iter_cases(orders: Sequence[int] = (3, 4, 5),
               families: Sequence[str] = FAMILIES,
               device="cuda") -> List[Case]:
    """The sweep grid: family × order × expression × DistInfo, with its
    operands on ``device``."""
    from repro_torch.planner import ir as pir
    from repro_torch.planner.config import default_config
    device = torch.device(device)
    cases: List[Case] = []
    for family in families:
        for order in orders:
            for expr in _family_exprs(family, order):
                for variant, dist_fields in _dist_variants(family):
                    cases.append(_build_case(family, expr, order, variant,
                                             dist_fields, device))
    # trailing-dense-axis reductions (values carry an R axis that rides
    # along unreduced — only the REDUCE family admits them)
    if "reduce" in families and 3 in orders:
        for variant, df in _dist_variants("reduce"):
            st = _make_sparse(_EXTENTS[3], device, dense_dim=_RANK)
            dist = None if df is None else pir.DistInfo(*df)
            ir = pir.build_ir("ijk->i", [st], dist=dist)
            cases.append(Case(f"reduce/o3+dense/{variant}", "reduce",
                              "ijk->i", ir, st, (), standin_ctx(dist),
                              default_config()))
    return cases


# ---------------------------------------------------------------------------
# path evaluation
# ---------------------------------------------------------------------------

def output_signature(out) -> Tuple:
    """Structure, shape, dtype and device of a path's output."""
    from repro_torch.core.sparse_tensor import SparseTensor
    if isinstance(out, SparseTensor):
        return ("SparseTensor", tuple(out.shape), tuple(out.values.shape),
                str(out.values.dtype), out.values.device.type)
    if isinstance(out, torch.Tensor):
        return ("Tensor", tuple(out.shape), str(out.dtype), out.device.type)
    if isinstance(out, (tuple, list)):
        return (type(out).__name__, tuple(output_signature(o) for o in out))
    return ("object", type(out).__name__)


def _corrupted(path: str, out):
    """``out``, or for the corrupted path an output with a leading axis."""
    if _CORRUPT_PATH is None or path != _CORRUPT_PATH:
        return out
    from repro_torch.core.sparse_tensor import SparseTensor
    t = out.values if isinstance(out, SparseTensor) else out
    return t.unsqueeze(0)


def run_path(ir, path: str, operands: Sequence, ctx, config):
    """One candidate path on concrete operands, under the collectives
    stand-in when the ctx names axes."""
    from repro_torch.planner import dispatch as pdispatch
    standin = ir.dist is not None and not ir.dist.is_local
    with (collective_standin() if standin else contextlib.nullcontext()):
        with torch.no_grad():
            out = pdispatch.execute(ir, path, list(operands), ctx=ctx,
                                    config=config)
    return _corrupted(path, out)


def path_signature(case: Case, path: str) -> Tuple:
    """Run one candidate path of a case and return its output signature."""
    ir = case.ir
    if case.st is None:
        ops: List = list(case.denses)
    else:
        ops = [None] * len(ir.operands)
        ops[ir.sparse_pos] = case.st
        for pos, dop in zip(ir.dense_positions, case.denses):
            ops[pos] = dop
    return output_signature(run_path(ir, path, ops, case.ctx, case.config))


def check_path_agreement(cases: Sequence[Case]) -> List[Finding]:
    """Contract 1: the same output signature from every candidate path."""
    from repro_torch.planner import cost as pcost
    findings: List[Finding] = []
    for case in cases:
        sigs: Dict[str, Tuple] = {}
        for path in pcost.candidate_paths(case.ir):
            try:
                sigs[path] = path_signature(case, path)
            except Exception as e:  # a candidate that cannot run IS a finding
                findings.append(Finding(
                    "contracts", 0, 0, "CT001",
                    f"[{case.name}] path {path!r} failed to run "
                    f"{case.expr!r}: {type(e).__name__}: {e}"))
        if len(set(sigs.values())) > 1:
            ref_path, ref = next(iter(sigs.items()))
            for path, sig in sigs.items():
                if sig != ref:
                    findings.append(Finding(
                        "contracts", 0, 0, "CT001",
                        f"[{case.name}] path {path!r} output {sig} disagrees "
                        f"with {ref_path!r} output {ref} for {case.expr!r}"))
    return findings


# ---------------------------------------------------------------------------
# cost-model invariants
# ---------------------------------------------------------------------------

def check_cost_invariants(cases: Sequence[Case]) -> List[Finding]:
    from repro_torch.planner import cost as pcost
    findings: List[Finding] = []

    def bad(case, msg):
        findings.append(Finding("contracts", 0, 0, "CT002",
                                f"[{case.name}] {msg}"))

    for case in cases:
        ir = case.ir
        costs = {p: pcost.estimate(ir, p)
                 for p in pcost.candidate_paths(ir)}
        for p, c in costs.items():
            again = pcost.estimate(ir, p)
            if c != again:
                bad(case, f"estimate({p!r}) is nondeterministic: "
                          f"{c} vs {again}")
            for field in ("flops", "mem", "comm"):
                v = getattr(c, field)
                if not math.isfinite(v) or v < 0:
                    bad(case, f"path {p!r} has invalid {field}={v!r}")
            if ir.dist is None and c.comm != 0.0:
                bad(case, f"path {p!r} charges comm={c.comm} on a LOCAL IR")
            if not math.isfinite(c.seconds) or c.seconds < 0:
                bad(case, f"path {p!r} has invalid seconds={c.seconds!r}")
        dense = costs.get("dense")
        if dense is not None:
            for p, c in costs.items():
                if p != "dense" and c.flops > dense.flops * (1 + 1e-9):
                    bad(case, f"sparse path {p!r} flops {c.flops} exceed the "
                              f"densified fallback's {dense.flops} at "
                              f"sub-saturation density — the §5.3 ranking "
                              f"premise is violated")
    return findings


# ---------------------------------------------------------------------------
# cache-key hygiene
# ---------------------------------------------------------------------------

def check_cache_keys(device="cuda") -> List[Finding]:
    """Plan-cache signatures over a grid of signature-relevant variations
    must be hashable, deterministic, and pairwise distinct."""
    from repro_torch.core.distributed import LOCAL, AxisCtx
    from repro_torch.planner import ir as pir
    from repro_torch.planner import plan as pplan
    from repro_torch.planner.config import PlannerConfig

    device = torch.device(device)
    cpu = torch.device("cpu")
    findings: List[Finding] = []
    expr = "ijk,jr,kr->ir"
    shape = (6, 4, 8)
    st = _make_sparse(shape, cpu)
    a, b = _make_factor(4, _RANK, 0, cpu), _make_factor(8, _RANK, 1, cpu)
    ops = (st, a, b)
    st_cap = type(st).from_coo(st.indices[:_NNZ], st.values[:_NNZ], shape,
                               cap=2 * _NNZ)

    def sig(label, operands=ops, path=None, ctx=LOCAL, dist=None,
            config=PlannerConfig()):
        return label, pplan._signature(expr, operands, path, ctx, dist,
                                       config)

    def axes(**sizes):
        return AxisCtx(data="data" if "data" in sizes else None,
                       model="model" if "model" in sizes else None,
                       sizes=tuple(sizes.items()))

    variations = [
        sig("base"),
        sig("cap", (st_cap, a, b)),
        sig("nnz", (_make_sparse(shape, cpu, nnz=4), a, b)),
        sig("dtype", (st.astype(torch.bfloat16), a, b)),
        sig("nnz_rows", (dataclasses.replace(st, nnz_rows=(3, 4, 5)), a,
                         b)),
        sig("shape", (_make_sparse((6, 4, 10), cpu), a,
                      _make_factor(10, _RANK, 1, cpu))),
        sig("path", path="all_at_once"),
        sig("ctx-data", ctx=axes(data=2), dist=pir.DistInfo(2, 1, False)),
        # same axis names, other sizes: must not share a plan
        sig("ctx-data4", ctx=axes(data=4), dist=pir.DistInfo(4, 1, False)),
        sig("ctx-model", ctx=axes(model=2), dist=pir.DistInfo(1, 2, False)),
        sig("rowsharded", ctx=axes(data=2), dist=pir.DistInfo(2, 1, True)),
        sig("config", config=PlannerConfig(block_rows=16)),
    ]
    if device != cpu:
        variations.append(sig("device", (_make_sparse(shape, device),
                                         a.to(device), b.to(device))))

    # determinism: rebuilding the same operands from scratch must reproduce
    # the same signature (hash and equality)
    _, base_key = variations[0]
    again = pplan._signature(
        expr, (_make_sparse(shape, cpu), _make_factor(4, _RANK, 0, cpu),
               _make_factor(8, _RANK, 1, cpu)), None, LOCAL, None,
        PlannerConfig())
    try:
        if base_key != again or hash(base_key) != hash(again):
            findings.append(Finding(
                "contracts", 0, 0, "CT003",
                "cache key is nondeterministic: identical configurations "
                "built twice produce different signatures"))
    except TypeError:
        pass  # unhashability is reported per variation below

    seen: Dict[Tuple, str] = {}
    for label, key in variations:
        try:
            hash(key)
        except TypeError as e:
            findings.append(Finding("contracts", 0, 0, "CT003",
                                    f"cache key {label!r} is unhashable: {e}"))
            continue
        if key in seen:
            findings.append(Finding(
                "contracts", 0, 0, "CT003",
                f"cache-key COLLISION: {label!r} and {seen[key]!r} produce "
                f"the same plan-cache signature — distinct configurations "
                f"would silently share a plan"))
        seen[key] = label
    return findings


# ---------------------------------------------------------------------------
# online certification (plan_contraction(validate=True))
# ---------------------------------------------------------------------------

def certify_candidates(ir, paths: Sequence[str], operands: Sequence,
                       ctx, config) -> None:
    """Raise :class:`PlanContractError` unless every candidate path of this
    concrete call gives the same output signature (each runs once on
    ``operands``). Called by ``plan_contraction(..., validate=True)`` before
    a new plan may enter the cache."""
    sigs: Dict[str, Tuple] = {}
    for path in paths:
        sigs[path] = output_signature(run_path(ir, path, operands, ctx,
                                               config))
    if len(set(sigs.values())) > 1:
        detail = "; ".join(f"{p}: {s}" for p, s in sorted(sigs.items()))
        raise PlanContractError(
            f"candidate paths of {ir.expr!r} disagree on their outputs — "
            f"refusing to cache a plan: {detail}")


# ---------------------------------------------------------------------------
# top-level entry
# ---------------------------------------------------------------------------

def run(orders: Sequence[int] = (3, 4, 5), device="cuda") -> List[Finding]:
    cases = iter_cases(orders, device=device)
    findings = check_path_agreement(cases)
    findings += check_cost_invariants(cases)
    findings += check_cache_keys(device)
    return findings
