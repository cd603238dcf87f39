"""SPMD pass 1 — sharding propagation over the planner's candidate paths:
the port's counterpart of the JAX package's ``analysis/spmd/sharding.py``.

An interpreter that assigns every tensor a *replication state* per mesh
axis and certifies that each candidate path of every planner family leaves
no partial sum unreduced. The state lattice, per (tensor, mesh axis), is
the reference's:

* ``("rep",)``         — replicated: every rank holds the same value.
* ``("shard", d)``     — rank-distinct along dimension ``d`` (``None`` when
  the owning dimension is unknown); ``("shard", d, ROWS)`` marks a
  globally indexed row space split across ranks (a row-sharded factor). A
  shard is *correct* per rank: it must never be summed.
* ``("part",)``        — partial sum: the true value is the sum over the
  axis. Sticky through arithmetic; only an all-reduce (or a
  reduce-scatter) discharges it.
* ``("over",)``        — over-reduced: a replicated value was summed again
  (the result is ``axis size ×`` the intended value).

Findings:

* ``SP001`` partial-sum escape — an output is ``part``: a psum is missing.
* ``SP002`` redundant psum     — a replicated value was all-reduced
  (``over``), or an over-reduced value escapes.
* ``SP003`` wrong replication state — a rank-distinct shard was
  all-reduced, or a shard escapes from a family whose output must be
  replicated over that axis.
* ``SP004`` sharded-dim gather — global indices into a ``ROWS`` shard (the
  all-gather is missing); an owner-aligned gather within a rank's own
  nonzero shard (untagged) is a legal local move.
* ``SP000`` analysis error     — a path failed to run, or an aten
  operation has no transfer rule (the finding names it).

How it runs, and where it departs from the reference. Torch has no jaxpr,
so nothing is traced abstractly: each candidate path of
``contracts.iter_cases`` RUNS, as the contract sweep runs it (tiny
concrete operands, on ``--device``), under a ``TorchDispatchMode`` that
keeps each tensor's states in a ``WeakTensorKeyDictionary`` and applies a
transfer rule per aten operation:

* elementwise operations join their inputs' states (right-aligned
  broadcasting), ``part`` sticky;
* reductions and ``mm``/``bmm`` contractions over a sharded dimension
  give ``part`` (``einsum`` and ``matmul`` reach the mode as these);
* ``index``/``index_select``/``gather`` with sharded indices give a shard
  of the indexed output; indexing a ``ROWS`` shard's rows is ``SP004``;
* ``index_add_``/``scatter_add_``/``index_put_(accumulate=True)`` of
  rank-distinct updates give ``part``;
* views, reshapes and permutes map dimensions; in-place operations set the
  state of the mutated tensor and of the tensor it views;
* an aten operation with no rule is an ``SP000`` finding that names it,
  never a silent ``rep`` (the reference joined unknown primitives
  conservatively).

Control flow runs concretely, so there is no fixpoint over loop carries;
a collective under a rank-varying branch or loop predicate is the AST
lint's ``SP101``/``SP102`` (``analysis/spmd/collectives.py``), not this
pass's (the reference's jaxpr walk found both).

Collectives are seen through the interpreter's own binding of
``core/collectives.py``: the contract sweep's stand-ins compute the
outputs (``contracts.collective_standin``, no process group) and the
reference's transitions apply on the axis the group belongs to (the
stand-in groups carry their axis names): an all-reduce sum takes
``part`` to ``rep``, ``rep`` to ``over`` (SP002) and a shard to SP003; an
all-gather takes a shard to ``rep``; a reduce-scatter takes ``part`` to a
row shard; a broadcast gives ``rep``; an exchange keeps the shard. Other
axes keep their states: an all-reduce over the data group leaves the
model axis as it was.

Kernel wrappers are leaves: ``kernels.ops._tttp`` (behind
``tttp_values``/``tttp_bucket_values``), ``mttkrp_bucketed`` and
``cg_matvec_bucketed`` run unobserved (on the card they launch the CUDA
kernels, whose ctypes launches no dispatch mode can see) and each applies
its own exact rule, which ``tests/test_torch_sharding.py`` holds equal to
the op-by-op interpretation of its plain version in ``kernels/ref.py`` (the
reference joined its ``pallas_call`` inputs conservatively). So is
``SparseTensor.row_buckets``: a bucket view is a local re-layout of the
rank's nonzeros, rank-distinct along its slot axis (dim 1) wherever the
nonzeros are sharded. So one sweep certifies the card's routes with the
kernels launched and the CPU's with the plain versions.

The sweep (:func:`run`/:func:`check_cases`) walks the ``contracts``
grid; :func:`certify_plan` is the online check behind
``plan_contraction(..., validate_spmd=True)``; :func:`set_fault` plants the
two seeded defects the tripwires prove the detector catches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import math
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.analysis.lint import Finding

REP = ("rep",)
PART = ("part",)
OVER = ("over",)

# the tag of a shard whose owning dimension is a GLOBALLY indexed row space
# split across ranks (a row-sharded factor): gathering into it with global
# coordinates is the missing-all-gather bug (SP004). Untagged shards are
# owner-aligned rank-local data (the nonzero shards of a sparse tensor).
ROWS = "rows"


def shard(dim: Optional[int] = None, tag: Optional[str] = None) -> Tuple:
    return ("shard", dim) if tag is None else ("shard", dim, tag)


def _tag(v: Tuple) -> Optional[str]:
    return v[2] if len(v) > 2 else None


def _is_shard(v: Tuple) -> bool:
    return v[0] == "shard"


State = Tuple                   # REP / PART / OVER / shard(d[, tag])
AxisStates = Dict[str, State]   # per mesh axis


class SpmdContractError(RuntimeError):
    """A candidate path's collective schedule is unsound (see findings)."""


# the deliberate-fault hook (CI tripwire): "missing-psum" turns the ctx's
# psums into identities, "double-psum" applies each twice; the sweep MUST
# then fail with SP001 / SP002
FAULTS = ("missing-psum", "double-psum")
_FAULT: Optional[str] = None


def set_fault(mode: Optional[str]) -> None:
    global _FAULT
    if mode is not None and mode not in FAULTS:
        raise ValueError(f"unknown fault {mode!r}; choose from {FAULTS}")
    _FAULT = mode


def _fault_ctx(ctx, mode: str):
    """``ctx`` with its psums planted with ``mode`` (the reference's
    ``_FaultCtx``): an ``AxisCtx`` subclass, so dispatch takes it as it
    is."""
    from repro_torch.core.distributed import AxisCtx

    @dataclasses.dataclass(frozen=True)
    class _FaultCtx(AxisCtx):
        def _apply(self, psum, x):
            if mode == "missing-psum":
                return x
            y = psum(x)
            return psum(y) if mode == "double-psum" else y

        def psum_data(self, x):
            return self._apply(super().psum_data, x)

        def psum_model(self, x):
            return self._apply(super().psum_model, x)

    return _FaultCtx(**{f.name: getattr(ctx, f.name)
                        for f in dataclasses.fields(AxisCtx)})


# ---------------------------------------------------------------------------
# joins and dimension maps
# ---------------------------------------------------------------------------

def join(states: Sequence[State]) -> State:
    """The reference's join: ``over`` beats ``part`` beats a shard beats
    ``rep``; shards of one (dim, tag) keep it, others lose the dim."""
    if any(v == OVER for v in states):
        return OVER
    if any(v == PART for v in states):
        return PART
    pairs = {(v[1], _tag(v)) for v in states if _is_shard(v)}
    if not pairs:
        return REP
    if len(pairs) == 1:
        return shard(*pairs.pop())
    return shard(None)


def _moved(v: State, dim_map: Callable[[int], object]) -> State:
    """``v`` with its shard dim mapped: ``dim_map(d)`` is a new dim, None
    (unknown) or ``"reduced"`` (summed away: ``part``)."""
    if not _is_shard(v):
        return v
    if v[1] is None:
        return shard(None)
    d = dim_map(v[1])
    if d == "reduced":
        return PART
    if d is None:
        return shard(None)
    return shard(d, _tag(v))


def _reshape_dim(in_shape, out_shape, d: int) -> Optional[int]:
    """Where dim ``d`` of ``in_shape`` lands in ``out_shape`` (the
    reference's reshape rule): the out dim whose preceding extents multiply
    to the same as ``d``'s and whose extent is ``d``'s; else unknown."""
    b = math.prod(in_shape[:d])
    acc = 1
    for j, s in enumerate(out_shape):
        if acc == b and s == in_shape[d]:
            return j
        acc *= s
    return None


def _shape(t) -> Tuple[int, ...]:
    return tuple(t.shape)


def _dims(dim, ndim: int) -> Tuple[int, ...]:
    """Reduced dims: None or an empty list means all of them."""
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(d % ndim if ndim else 0 for d in dim)


# aten operations by rule
_POINTWISE = frozenset("""
abs absolute acos add addcdiv addcmul angle asin atan atan2 bitwise_and
bitwise_left_shift bitwise_not bitwise_or bitwise_right_shift bitwise_xor
ceil clamp clamp_max clamp_min clone copysign cos cosh deg2rad div
eq erf erfc exp exp2 expm1 fill float_power floor floor_divide fmax fmin fmod
frac ge gt hypot isfinite isinf isnan isneginf isposinf le lerp lift_fresh
log log10 log1p log2 logaddexp logical_and logical_not logical_or logical_xor
lt masked_fill maximum minimum mul nan_to_num ne neg nextafter positive pow
rad2deg reciprocal relu remainder round rsqrt rsub sigmoid sign signbit sin
sinh softplus sqrt square sub tan tanh threshold true_divide trunc where
xlogy _to_copy copy
""".split())
_REDUCTIONS = frozenset("""
sum mean nansum amax amin prod any all argmax argmin std var logsumexp
count_nonzero norm linalg_vector_norm
""".split())
_FACTORIES = frozenset("""
arange empty empty_like empty_strided eye full full_like linspace logspace
new_empty new_empty_strided new_full new_ones new_zeros ones ones_like rand
rand_like randint randint_like randn randn_like randperm scalar_tensor zeros
zeros_like
""".split())
# same shape, same dims: each rank's result over its own data
_SAME_DIMS = frozenset("""
sort argsort cumsum cumprod cummax cummin flip roll topk constant_pad_nd
repeat tril triu kthvalue
""".split())
# no tensor result, or nothing to track
_NO_STATE = frozenset("""
_local_scalar_dense promote_types result_type is_nonzero equal
is_same_size sym_size sym_stride sym_numel sym_storage_offset
record_stream _has_compatible_shallow_copy_type set_ resize_
""".split())
# rank-distinct with an unknown dim when any input is sharded
_DATA_DEPENDENT = frozenset("""
nonzero unique _unique2 unique_consecutive unique_dim masked_select
repeat_interleave bucketize searchsorted histc isin
""".split())
_VIEWS = frozenset("""
view _unsafe_view _reshape_alias expand permute transpose t unsqueeze squeeze
select slice as_strided alias detach diagonal
""".split())


def _bind(func, args, kwargs) -> Dict[str, object]:
    """The operation's arguments by schema name, defaults filled in."""
    schema = func._schema
    out: Dict[str, object] = {}
    for a, v in zip(schema.arguments, args):
        out[a.name] = v
    out.update(kwargs)
    for a in schema.arguments:
        if a.name not in out and a.has_default_value():
            out[a.name] = a.default_value
    return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

class _Interp(TorchDispatchMode):
    """The dispatch mode that carries the states. ``suspended`` > 0 lets
    operations through unobserved (inside a leaf or a collective
    stand-in, whose result gets its state from the leaf's rule)."""

    def __init__(self, axes: Sequence[str], label: str):
        super().__init__()
        self.axes = tuple(axes)
        self.label = label
        self.states = WeakTensorKeyDictionary()
        self.findings: List[Finding] = []
        self.suspended = 0

    # -- bookkeeping --------------------------------------------------------
    def finding(self, rule: str, msg: str) -> None:
        self.findings.append(Finding("spmd", 0, 0, rule,
                                     f"[{self.label}] {msg}"))

    def rep(self) -> AxisStates:
        return {ax: REP for ax in self.axes}

    def get(self, t) -> AxisStates:
        if not isinstance(t, torch.Tensor):
            return self.rep()
        st = self.states.get(t)
        return dict(st) if st is not None else self.rep()

    def put(self, t, st: AxisStates) -> None:
        if isinstance(t, torch.Tensor):
            self.states[t] = {ax: st.get(ax, REP) for ax in self.axes}

    @contextlib.contextmanager
    def suspend(self):
        self.suspended += 1
        try:
            yield
        finally:
            self.suspended -= 1

    def per_axis(self, fn: Callable[[str], State]) -> AxisStates:
        return {ax: fn(ax) for ax in self.axes}

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        name = func.overloadpacket.__name__
        a = _bind(func, args, kwargs)
        outs = _tensors(out) if not isinstance(out, torch.Tensor) else [out]
        if name in _NO_STATE or not outs:
            return out
        rule = self._rule(name)
        if rule is None:
            self.finding("SP000", f"aten.{name} has no transfer rule: the "
                                  f"interpreter cannot say what it does to "
                                  f"a sharded or partial operand")
            st = self.per_axis(lambda ax: join(
                [_moved(self.get(t)[ax], lambda d: None)
                 for t in _all_inputs(a)]))
            for o in outs:
                self.put(o, st)
            return out
        states = rule(name, a, outs)
        if isinstance(states, dict):
            states = [states] * len(outs)
        for o, st in zip(outs, states):
            self.put(o, st)
        if name.endswith("_") and isinstance(a.get("self"), torch.Tensor):
            self._mutated(a["self"], states[0])
        return out

    def _mutated(self, t: torch.Tensor, st: AxisStates) -> None:
        """An in-place write: ``t`` takes ``st``, and the tensor it views
        takes the join of its own state with the write's (dims mapped when
        the shapes agree, else unknown)."""
        self.put(t, st)
        base = t._base
        if base is None:
            return
        same = _shape(base) == _shape(t)
        old = self.get(base)
        self.put(base, self.per_axis(lambda ax: join(
            [old[ax], st[ax] if same else _moved(st[ax], lambda d: None)])))

    def _rule(self, name: str):
        bare = name[:-1] if name.endswith("_") else name
        for table, rule in ((_POINTWISE, self._pointwise),
                            (_REDUCTIONS, self._reduction),
                            (_FACTORIES, self._factory),
                            (_SAME_DIMS, self._same_dims),
                            (_DATA_DEPENDENT, self._data_dependent),
                            (_VIEWS, self._view)):
            if bare in table:
                return rule
        return {"mm": self._matmul, "bmm": self._matmul,
                "addmm": self._matmul, "baddbmm": self._matmul,
                "dot": self._matmul, "vdot": self._matmul,
                "mv": self._matmul, "addmv": self._matmul,
                "max": self._max_min, "min": self._max_min,
                "index": self._index, "index_select": self._index_select,
                "gather": self._gather,
                "index_add": self._index_add,
                "scatter_add": self._scatter, "scatter_reduce": self._scatter,
                "scatter": self._scatter, "index_put": self._index_put,
                "_index_put_impl": self._index_put,
                "bincount": self._bincount, "cat": self._cat,
                "stack": self._stack, "split": self._split,
                "split_with_sizes": self._split, "unbind": self._unbind,
                "chunk": self._split, "zero": self._factory}.get(bare)

    # -- rules --------------------------------------------------------------
    def _pointwise(self, name, a, outs):
        n = outs[0].dim()
        ins = _all_inputs(a)
        if name in ("copy_", "fill_"):         # overwrites self
            ins = [t for k, t in a.items() if k != "self"
                   and isinstance(t, torch.Tensor)]
        return self.per_axis(lambda ax: join(
            [_moved(self.get(t)[ax], lambda d, k=t.dim(): d + n - k)
             for t in ins]))

    def _factory(self, name, a, outs):
        return self.rep()

    def _reduction(self, name, a, outs):
        x = a["self"]
        dims = set(_dims(a.get("dim"), x.dim()))
        keep = bool(a.get("keepdim", False))

        def where(d):
            if d in dims:
                return "reduced"
            return d if keep else d - sum(1 for r in dims if r < d)
        return self.per_axis(lambda ax: _moved(self.get(x)[ax], where))

    def _max_min(self, name, a, outs):
        if "other" in a:                      # elementwise max/min
            return self._pointwise(name, a, outs)
        return self._reduction(name, a, outs)

    def _same_dims(self, name, a, outs):
        x = a["self"]
        return self.per_axis(lambda ax: self.get(x)[ax])

    def _data_dependent(self, name, a, outs):
        return self.per_axis(lambda ax: join(
            [_moved(self.get(t)[ax], lambda d: None)
             for t in _all_inputs(a)]))

    def _view(self, name, a, outs):
        x = a["self"]
        src, dst = _shape(x), _shape(outs[0])
        n = len(dst)
        if name == "permute":
            where = [p % max(len(src), 1) for p in a["dims"]].index
        elif name in ("transpose", "t") and len(src) >= 2:
            d0, d1 = ((a["dim0"] % len(src), a["dim1"] % len(src))
                      if name == "transpose" else (0, 1))

            def where(d):
                return d1 if d == d0 else (d0 if d == d1 else d)
        elif name == "unsqueeze":
            k = a["dim"] % n

            def where(d):
                return d + 1 if d >= k else d
        elif name == "squeeze":
            sq = [d for d in _dims(a.get("dim"), len(src))
                  if src[d] == 1] if len(src) else []

            def where(d):
                return None if d in sq else d - sum(1 for s in sq if s < d)
        elif name == "select":
            k = a["dim"] % len(src)

            def where(d):
                return None if d == k else (d - 1 if d > k else d)
        elif name in ("slice", "as_strided", "alias", "detach", "t") \
                and len(src) == n:
            def where(d):
                return d
        elif name == "expand":
            def where(d):
                return d + n - len(src)
        elif name == "diagonal":
            def where(d):
                return None
        else:                                 # view, _unsafe_view, ...
            def where(d):
                return _reshape_dim(src, dst, d)
        return self.per_axis(lambda ax: _moved(self.get(x)[ax], where))

    def _matmul(self, name, a, outs):
        n = outs[0].dim()
        if name in ("mm", "addmm"):
            lhs, rhs = a["mat1" if name == "addmm" else "self"], \
                a["mat2"]
            lm = {0: 0, 1: "reduced"}
            rm = {0: "reduced", 1: 1}
        elif name in ("bmm", "baddbmm"):
            lhs, rhs = (a["batch1"], a["batch2"]) if name == "baddbmm" \
                else (a["self"], a["mat2"])
            lm = {0: 0, 1: 1, 2: "reduced"}
            rm = {0: 0, 1: "reduced", 2: 2}
        elif name in ("dot", "vdot"):
            lhs, rhs = a["self"], a.get("tensor", a.get("other"))
            lm = rm = {0: "reduced"}
        else:                                 # mv, addmv
            lhs, rhs = a["mat"] if name == "addmv" else a["self"], a["vec"]
            lm = {0: 0, 1: "reduced"}
            rm = {0: "reduced"}
        bias = a.get("self") if name in ("addmm", "baddbmm", "addmv") \
            else None

        def st(ax):
            parts = [_moved(self.get(lhs)[ax], lm.get),
                     _moved(self.get(rhs)[ax], rm.get)]
            if bias is not None:
                parts.append(_moved(self.get(bias)[ax],
                                    lambda d, k=bias.dim(): d + n - k))
            return join(parts)
        return self.per_axis(st)

    def _gathered(self, ax, v: State) -> State:
        """The state a gather takes from its source's state ``v`` when the
        source's sharded dim is indexed: SP004 for a ROWS shard, else a
        rank-local move; both rank-distinct with an unknown dim."""
        if _tag(v) == ROWS:
            self.finding(
                "SP004", f"gather indexes into dimension {v[1]} of a value "
                         f"row-sharded over axis {ax!r}: each rank resolves "
                         f"global indices against its local shard; "
                         f"all-gather the operand (or take the rowsharded "
                         f"path) first")
        return shard(None)

    def _index(self, name, a, outs):
        x, idx = a["self"], list(a["indices"])
        pos = [i for i, t in enumerate(idx) if t is not None]
        ind = [idx[i] for i in pos]
        if any(t.dtype == torch.bool for t in ind):
            return self._data_dependent(name, a, outs)
        b = max((t.dim() for t in ind), default=0)
        consecutive = pos == list(range(pos[0], pos[-1] + 1)) if pos else True
        base = pos[0] if consecutive and pos else 0
        rest = [d for d in range(x.dim()) if d not in pos]

        def self_dim(d):
            if consecutive:
                return d if d < base else d - len(pos) + b
            return b + rest.index(d)

        def st(ax):
            v = self.get(x)[ax]
            parts = []
            if _is_shard(v) and v[1] in pos:
                parts.append(self._gathered(ax, v))
            else:
                parts.append(_moved(v, self_dim))
            for t in ind:
                parts.append(_moved(self.get(t)[ax],
                                    lambda e, k=t.dim(): base + e + b - k))
            return join(parts)
        return self.per_axis(st)

    def _index_select(self, name, a, outs):
        x, dim, index = a["self"], a["dim"] % max(a["self"].dim(), 1), \
            a["index"]

        def st(ax):
            v = self.get(x)[ax]
            first = (self._gathered(ax, v)
                     if _is_shard(v) and v[1] == dim else v)
            return join([first, _moved(self.get(index)[ax],
                                       lambda e: dim)])
        return self.per_axis(st)

    def _gather(self, name, a, outs):
        x, dim, index = a["self"], a["dim"] % max(a["self"].dim(), 1), \
            a["index"]

        def st(ax):
            v = self.get(x)[ax]
            first = (self._gathered(ax, v)
                     if _is_shard(v) and v[1] == dim else v)
            return join([first, self.get(index)[ax]])
        return self.per_axis(st)

    def _scattered(self, ax, target: torch.Tensor, updates, additive: bool,
                   dim_of: Callable[[int], object], index=()):
        """The reference's scatter rule: rank-distinct updates (or
        indices) summed into shared slots give ``part``; a write that is
        not additive gives a shard of unknown dim; updates sharded along a
        kept dim keep it."""
        parts = [self.get(target)[ax]]
        for u in updates:
            v = self.get(u)[ax]
            if not _is_shard(v):
                parts.append(v)
                continue
            d = dim_of(v[1]) if v[1] is not None else "scattered"
            if d == "scattered":
                parts.append(PART if additive else shard(None))
            else:
                parts.append(shard(d, _tag(v)))
        for t in index:
            v = self.get(t)[ax]
            parts.append((PART if additive else shard(None))
                         if _is_shard(v) else v)
        return join(parts)

    def _index_add(self, name, a, outs):
        x, dim = a["self"], a["dim"] % max(a["self"].dim(), 1)
        return self.per_axis(lambda ax: self._scattered(
            ax, x, [a["source"]], True,
            lambda e: "scattered" if e == dim else e, [a["index"]]))

    def _scatter(self, name, a, outs):
        x, dim = a["self"], a["dim"] % max(a["self"].dim(), 1)
        additive = name.startswith("scatter_add") or (
            name.startswith("scatter_reduce")
            and a.get("reduce") in ("sum", "mean"))
        src = [a["src"]] if isinstance(a.get("src"), torch.Tensor) else []
        return self.per_axis(lambda ax: self._scattered(
            ax, x, src, additive,
            lambda e: "scattered" if e == dim else e, [a["index"]]))

    def _index_put(self, name, a, outs):
        x, idx = a["self"], [t for t in a["indices"] if t is not None]
        vals = a["values"]
        additive = bool(a.get("accumulate", False))
        pos = [i for i, t in enumerate(a["indices"]) if t is not None]
        b = max((t.dim() for t in idx), default=0)
        consecutive = pos == list(range(pos[0], pos[-1] + 1)) if pos else True
        base = pos[0] if consecutive and pos else 0
        rest = [d for d in range(x.dim()) if d not in pos]
        nres = x.dim() - len(pos) + b

        def target_dim(e):
            r = e + nres - vals.dim()           # result dim of the update
            if consecutive:
                if r < base:
                    return r
                if r < base + b:
                    return "scattered"
                return r - b + len(pos)
            if r < b:
                return "scattered"
            return rest[r - b] if r - b < len(rest) else None
        return self.per_axis(lambda ax: self._scattered(
            ax, x, [vals], additive, target_dim, idx))

    def _bincount(self, name, a, outs):
        # counts of rank-local indices: a scatter-add
        w = a.get("weights")
        return self.per_axis(lambda ax: self._scattered(
            ax, outs[0], [w] if isinstance(w, torch.Tensor) else [], True,
            lambda e: "scattered", [a["self"]]))

    def _cat(self, name, a, outs):
        ts = [t for t in a["tensors"] if t.numel() or t.dim() > 1]
        dim = a.get("dim", 0) % max(outs[0].dim(), 1)
        return self.per_axis(lambda ax: join(
            [_moved(self.get(t)[ax], lambda d: None if d == dim else d)
             for t in ts]))

    def _stack(self, name, a, outs):
        dim = a.get("dim", 0) % max(outs[0].dim(), 1)
        return self.per_axis(lambda ax: join(
            [_moved(self.get(t)[ax], lambda d: d + 1 if d >= dim else d)
             for t in a["tensors"]]))

    def _split(self, name, a, outs):
        x = a["self"]
        return [self.per_axis(lambda ax: self.get(x)[ax]) for _ in outs]

    def _unbind(self, name, a, outs):
        x, dim = a["self"], a.get("dim", 0) % max(a["self"].dim(), 1)
        st = self.per_axis(lambda ax: _moved(
            self.get(x)[ax],
            lambda d: None if d == dim else (d - 1 if d > dim else d)))
        return [st for _ in outs]

    # -- collectives (observed through _bound) ------------------------------
    def collective(self, name: str, a: Dict[str, object], out) -> None:
        """The transition of collective ``name`` (arguments ``a`` by the
        stand-in's parameter names, result ``out``)."""
        if name in ("all_reduce_ints", "barrier"):
            return
        group = a.get("group")
        axis = getattr(group, "axis", None)
        if name == "exchange":
            for s, o in zip(a["sends"], out):
                self.put(o, self.get(s))
            return
        x = a.get("x")
        res = out.wait() if not isinstance(out, torch.Tensor) else out
        st = self.get(x)
        if axis is None or axis not in self.axes:
            self.finding("SP000", f"{name} over a group of no mesh axis "
                                  f"({group!r}): the interpreter cannot "
                                  f"say which axis it reduces")
            self.put(res, st)
            return
        cur = st[axis]
        if name == "all_reduce":
            if a.get("op", "sum") != "sum":
                st[axis] = OVER if cur == OVER else REP
            elif cur == PART:
                st[axis] = REP
            elif cur == OVER:
                st[axis] = OVER
            elif _is_shard(cur):
                self.finding(
                    "SP003", f"all-reduce over axis {axis!r} of a "
                             f"rank-distinct shard: shards are per-rank "
                             f"results, not partial sums; summing them "
                             f"mixes rows")
                st[axis] = REP
            else:
                self.finding(
                    "SP002", f"redundant all-reduce over axis {axis!r}: the "
                             f"operand is already replicated, so the result "
                             f"is axis size x the intended value")
                st[axis] = OVER
        elif name == "all_gather":
            st[axis] = cur if cur in (PART, OVER) else REP
        elif name == "reduce_scatter":
            if cur == PART:
                st[axis] = shard(0)
            elif cur == REP:
                self.finding(
                    "SP002", f"reduce-scatter over axis {axis!r} of a "
                             f"replicated value: each block is axis size x "
                             f"the slice")
                st[axis] = OVER
            elif _is_shard(cur):
                self.finding(
                    "SP003", f"reduce-scatter over axis {axis!r} of a "
                             f"rank-distinct shard mixes unrelated rows")
                st[axis] = shard(None)
        elif name == "broadcast":
            st[axis] = REP
        self.put(res, st)


def _all_inputs(a: Dict[str, object]) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for v in a.values():
        out += _tensors(v)
    return out


# ---------------------------------------------------------------------------
# leaves: the kernel wrappers and the bucket view
# ---------------------------------------------------------------------------

def _gathered_rows(interp: _Interp, ax: str, f, ix: State,
                   col: int) -> State:
    """``f[idx]``: the rows of factor ``f`` gathered by an index array of
    state ``ix`` (already moved to the output's dims), the factor's column
    dim landing at ``col``: its rows indexed (SP004 on a ROWS shard)."""
    v = interp.get(f)[ax]
    if _is_shard(v) and v[1] == 0:
        v = interp._gathered(ax, v)
    elif _is_shard(v):
        v = _moved(v, lambda d: col)
    return join([v, ix])


def _tttp_rule(interp: _Interp, values, indices, valid, factors
               ) -> AxisStates:
    """TTTP, ``values[n] · Σ_r Π_d A_d[indices[n, d], r]`` and 0 off
    ``valid``, in the order its plain version (``kernels.ref.tttp_ref``)
    composes it: each factor's rows gathered by its index column, their
    product summed over r (a column shard gives ``part``), then times the
    values where valid."""
    def st(ax):
        col = _moved(interp.get(indices)[ax],
                     lambda d: 0 if d == 0 else None)
        prod = join([_gathered_rows(interp, ax, f, col, 1)
                     for f in factors if f is not None])
        summed = _moved(prod, lambda d: "reduced" if d == 1 else d)
        return join([summed, interp.get(values)[ax],
                     interp.get(valid)[ax]])
    return interp.per_axis(st)


def _segment(key: State, contrib: State) -> State:
    """Slot contributions (nb, C, R) summed into (nb·block_rows, R) rows by
    a key (nb, C), the plain versions' one-hot product (``kernels.tile.
    scatter_rows``): a shard along the slot axis gives ``part``; the
    column dim survives as dim 1."""
    onehot = _moved(key, lambda d: 2 if d == 1 else d)
    rows = join([_moved(onehot, {0: 0, 1: 1, 2: "reduced"}.get),
                 _moved(contrib, {0: 0, 1: "reduced", 2: 2}.get)])
    return _moved(rows, lambda d: 1 if d == 2 else None)


def _bucket_rule(interp: _Interp, buckets, factors, x=None) -> AxisStates:
    """The bucketed MTTKRP (``x`` None) and the fused Gram matvec over a
    bucket view, in the order their plain versions
    (``kernels.ref.mttkrp_bucketed_ref``, ``cg_matvec_bucketed_ref``)
    compose them: the Khatri-Rao product of the non-target factors' rows
    (gathered by the bucket indices: SP004 on a ROWS shard), for the
    matvec dotted with x's rows over r (a column shard gives ``part``) and
    weighted, then summed into the output rows by the slot key (the
    kernel's key joins ``valid`` to ``local_row``)."""
    mode = buckets.mode

    def st(ax):
        ix = interp.get(buckets.indices)[ax]
        col = _moved(ix, lambda d: d if d < 2 else None)
        kr = [_gathered_rows(interp, ax, f, col, 2)
              for d, f in enumerate(factors) if d != mode and f is not None]
        key = join([interp.get(buckets.local_row)[ax],
                    interp.get(buckets.valid)[ax]])
        w = interp.get(buckets.values)[ax]
        if x is None:
            return _segment(key, join([w] + kr))
        dot = _moved(join(kr + [_gathered_rows(interp, ax, x, col, 2)]),
                     lambda d: "reduced" if d == 2 else d)
        return _segment(key, join([w, dot] + kr))
    return interp.per_axis(st)


def _row_buckets_rule(interp: _Interp, st, buckets) -> None:
    """A bucket view: the rank's nonzeros re-laid out by row block, so
    rank-distinct along the slot axis (dim 1) wherever the nonzeros are
    sharded; the values also carry their own ``part``/``over``."""
    def slot(v):
        return shard(1) if _is_shard(v) else v
    structure = interp.per_axis(lambda ax: slot(join(
        [interp.get(st.indices)[ax], interp.get(st.valid)[ax]])))
    values = interp.per_axis(lambda ax: slot(join(
        [interp.get(st.values)[ax], interp.get(st.indices)[ax],
         interp.get(st.valid)[ax]])))
    interp.put(buckets.values, values)
    for t in (buckets.indices, buckets.local_row, buckets.valid):
        interp.put(t, structure)


# the interpreter running on each thread (and analyze_fn's stand-in axis
# groups): a kernel leaf called on another thread meanwhile runs as it
# would unbound, and leaves no state in this thread's certificate
_LOCAL = threading.local()


def _active() -> Optional[_Interp]:
    return getattr(_LOCAL, "interp", None)


def _leaf(fn: Callable, rule: Callable) -> Callable:
    """``fn`` run unobserved by this thread's interpreter, its result's
    state set by ``rule(interp, result, *args, **kwargs)``; ``fn`` alone
    on a thread that runs none."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        interp = _active()
        if interp is None or interp.suspended:
            return fn(*args, **kwargs)
        with interp.suspend():
            out = fn(*args, **kwargs)
        rule(interp, out, *args, **kwargs)
        return out
    return wrapped


def _tttp_leaf(interp, out, values, indices, valid, factors, tile=None):
    interp.put(out, _tttp_rule(interp, values, indices, valid, factors))


def _mttkrp_leaf(interp, out, buckets, factors, num_rows=None, tile=None):
    interp.put(out, _bucket_rule(interp, buckets, factors))


def _cg_leaf(interp, out, buckets, factors, x, num_rows=None, tile=None):
    interp.put(out, _bucket_rule(interp, buckets, factors, x))


def _row_buckets_leaf(interp, out, st, mode, block_rows):
    _row_buckets_rule(interp, st, out)


@contextlib.contextmanager
def _bound(interp: _Interp):
    """The interpreter active on this thread, its leaves and collectives
    bound. The bindings are module attributes, so one check runs at a time
    (``contracts.STANDIN_LOCK``); other threads' kernel calls and
    collectives pass through them unobserved and unchanged."""
    from repro_torch.analysis import contracts
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import ops as kops

    def observed(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            with interp.suspend():
                out = fn(*args, **kwargs)
            interp.collective(name, bound.arguments, out)
            return out
        return call

    with contracts.STANDIN_LOCK:
        saved = [(kops, "_tttp", kops._tttp),
                 (kops, "mttkrp_bucketed", kops.mttkrp_bucketed),
                 (kops, "cg_matvec_bucketed", kops.cg_matvec_bucketed),
                 (SparseTensor, "row_buckets", SparseTensor.row_buckets)]
        kops._tttp = _leaf(kops._tttp, _tttp_leaf)
        kops.mttkrp_bucketed = _leaf(kops.mttkrp_bucketed, _mttkrp_leaf)
        kops.cg_matvec_bucketed = _leaf(kops.cg_matvec_bucketed, _cg_leaf)
        SparseTensor.row_buckets = _leaf(SparseTensor.row_buckets,
                                         _row_buckets_leaf)
        outer, _LOCAL.interp = _active(), interp
        try:
            with contracts.collective_standin(wrap=observed), interp:
                yield
        finally:
            _LOCAL.interp = outer
            for owner, name, fn in saved:
                setattr(owner, name, fn)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _check_outputs(label: str, out_states: Sequence[AxisStates],
                   allowed_shard_axes: Sequence[str]) -> List[Finding]:
    """No partial sums or over-reductions may escape; shards only over the
    axes allowed."""
    findings: List[Finding] = []

    def f(rule, msg):
        findings.append(Finding("spmd", 0, 0, rule, f"[{label}] {msg}"))

    for i, st in enumerate(out_states):
        for ax, v in st.items():
            if v == PART:
                f("SP001", f"partial-sum ESCAPE: output leaf {i} is an "
                           f"unreduced partial over axis {ax!r}: an "
                           f"all-reduce over {ax!r} is missing")
            elif v == OVER:
                f("SP002", f"output leaf {i} is over-reduced over axis "
                           f"{ax!r} (a redundant all-reduce upstream)")
            elif _is_shard(v) and ax not in allowed_shard_axes:
                f("SP003", f"output leaf {i} is rank-distinct over axis "
                           f"{ax!r} but this output must be replicated")
    return findings


def _leaves(out) -> List[torch.Tensor]:
    from repro_torch.core.sparse_tensor import SparseTensor
    if isinstance(out, SparseTensor):
        return [out.indices, out.values, out.valid]
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def axis_group(name: str):
    """The stand-in process group of mesh axis ``name`` in the running
    :func:`analyze_fn`: what a function under analysis hands
    ``core.collectives`` (``coll.all_reduce(x, axis_group("data"))``) where
    a real program hands its ctx's group."""
    groups = getattr(_LOCAL, "groups", None)
    if not groups or name not in groups[-1]:
        raise RuntimeError(f"axis_group({name!r}) outside analyze_fn, or "
                           f"not an axis of its axis_env")
    return groups[-1][name]


def analyze_fn(fn, args: Sequence, in_states: Sequence[AxisStates],
               axis_env: Sequence[Tuple[str, int]],
               expected: Optional[Dict[str, object]] = None,
               label: str = "fn") -> List[Finding]:
    """Fixture and unit entry: run ``fn(*args)`` (concrete tensors) under
    the interpreter over the mesh axes of ``axis_env`` and certify its
    outputs. ``in_states`` align with the positional args; ``expected``
    maps each axis to ``"rep"`` (shards escaping are SP003) or
    ``"shard"`` (rank-distinct outputs are legal, the default). Inside
    ``fn``, :func:`axis_group` gives each axis's group."""
    from repro_torch.analysis.contracts import StandInGroup
    sizes = dict((str(n), int(s)) for n, s in axis_env)
    interp = _Interp(tuple(sizes), label)
    if not hasattr(_LOCAL, "groups"):
        _LOCAL.groups = []
    groups = _LOCAL.groups
    groups.append({n: StandInGroup(s, axis=n) for n, s in sizes.items()})
    try:
        for t, st in zip(args, in_states):
            interp.put(t, {ax: tuple(v) for ax, v in st.items()})
        with _bound(interp):
            out = fn(*args)
        outs = [interp.get(t) for t in _leaves(out)]
    except Exception as e:
        return [Finding("spmd", 0, 0, "SP000",
                        f"[{label}] failed to run: {type(e).__name__}: {e}")]
    finally:
        groups.pop()
    expected = expected or {}
    allowed = [ax for ax in sizes
               if str(expected.get(ax, "shard")).startswith("shard")]
    return interp.findings + _check_outputs(label, outs, allowed)


# ---------------------------------------------------------------------------
# the planner-path sweep
# ---------------------------------------------------------------------------

def _operand_states(axes: Sequence[str], data_axes: Sequence[str],
                    model_axes: Sequence[str], rowsharded: bool
                    ) -> Tuple[AxisStates, AxisStates]:
    """(state of the sparse tensor's values, indices and valid; state of
    every dense operand), the reference's ``_operand_states``: data axes
    shard the nonzeros (dim 0, untagged: owner-aligned) and, when
    ``rowsharded``, the factors' rows (ROWS); model axes shard factor
    columns (dim 1)."""
    sp = {ax: REP for ax in axes}
    dn = {ax: REP for ax in axes}
    for ax in data_axes:
        sp[ax] = shard(0)
        dn[ax] = shard(0, ROWS) if rowsharded else REP
    for ax in model_axes:
        dn[ax] = shard(1)
    return sp, dn


def _allowed_shard_axes(family: str, path: str, data_axes: Sequence[str],
                        model_axes: Sequence[str]) -> List[str]:
    """Axes over which a rank-distinct OUTPUT is legal (the reference's):
    TTTP outputs ride the data-sharded nonzeros; the rowsharded MTTKRP's
    reduce-scatter leaves row ownership on the data axes; MTTKRP, TTM and
    CG outputs stay column-sharded under a model axis."""
    allowed: List[str] = []
    if family == "tttp" or path == "rowsharded":
        allowed += list(data_axes)
    if family in ("mttkrp", "mttkrp_partial", "cg_matvec", "ttm"):
        allowed += list(model_axes)
    return allowed


def _axes_of(ctx) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    data = ctx._data_names()
    model = (ctx.model,) if ctx.model is not None else ()
    return tuple(data), tuple(model)


def _analyze_execution(ir, path: str, st, denses: Sequence, ctx, config,
                       family: str, label: str) -> List[Finding]:
    """Run one (IR, path) on fresh copies of the sparse leaves (no cached
    bucket patterns or views carried in) and the dense operands, each with
    its operand state, and certify the output."""
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.planner import dispatch as pdispatch
    data_axes, model_axes = _axes_of(ctx)
    axes = data_axes + model_axes
    rowsharded = bool(ir.dist is not None and ir.dist.rowsharded)
    sp_state, dn_state = _operand_states(axes, data_axes, model_axes,
                                         rowsharded)
    interp = _Interp(axes, label)
    run_ctx = _fault_ctx(ctx, _FAULT) if _FAULT is not None else ctx
    ops: List = list(denses)
    if st is not None:
        st = SparseTensor(st.indices.clone(), st.values.clone(),
                          st.valid.clone(), st.shape, st.nnz,
                          st.sorted_mode, st.nnz_rows)
        for t in (st.indices, st.values, st.valid):
            interp.put(t, sp_state)
        ops = [None] * len(ir.operands)
        ops[ir.sparse_pos] = st
        for pos, d in zip(ir.dense_positions, denses):
            ops[pos] = d
    for d in denses:
        interp.put(d, dn_state)
    try:
        with _bound(interp), torch.no_grad():
            out = pdispatch.execute(ir, path, ops, ctx=run_ctx,
                                    config=config)
        outs = [interp.get(t) for t in _leaves(out)]
    except Exception as e:
        tb = traceback.extract_tb(e.__traceback__)[-1]
        return [Finding("spmd", 0, 0, "SP000",
                        f"[{label}] failed to run: {type(e).__name__}: {e} "
                        f"({tb.filename.rsplit('/', 1)[-1]}:{tb.lineno})")]
    allowed = _allowed_shard_axes(family, path, data_axes, model_axes)
    return interp.findings + _check_outputs(label, outs, allowed)


def check_cases(cases=None, orders: Sequence[int] = (3, 4, 5),
                device="cuda") -> List[Finding]:
    """The sweep: every candidate path of every ``contracts.iter_cases``
    grid point (on ``device``), certified for collective soundness."""
    from repro_torch.analysis import contracts
    from repro_torch.planner import cost as pcost
    if cases is None:
        cases = contracts.iter_cases(orders, device=device)
    findings: List[Finding] = []
    for case in cases:
        for path in pcost.candidate_paths(case.ir):
            findings += _analyze_execution(
                case.ir, path, case.st, case.denses, case.ctx, case.config,
                case.family, label=f"{case.name}/{path}")
    return findings


def run(orders: Sequence[int] = (3, 4, 5), device="cuda") -> List[Finding]:
    return check_cases(orders=orders, device=device)


# ---------------------------------------------------------------------------
# online certification (plan_contraction(..., validate_spmd=True))
# ---------------------------------------------------------------------------

def _family_tag(ir) -> str:
    from repro_torch.planner import ir as pir
    if ir.kind == pir.TTTP:
        return "tttp"
    if ir.kind == pir.REDUCE:
        return "reduce"
    if ir.kind == pir.TTM:
        return "ttm"
    if ir.kind == pir.MTTKRP:
        return "mttkrp" if pir.is_classic_mttkrp(ir) else "mttkrp_partial"
    if ir.kind == pir.CG_MATVEC:
        return "cg_matvec"
    return "dense"


def certify_plan(ir, paths: Sequence[str], operands: Sequence, ctx,
                 config) -> None:
    """Raise :class:`SpmdContractError` unless every candidate path of this
    call is collective-sound: no partial-sum escapes, no redundant or
    wrong-axis all-reduces, no gathers into row-sharded factors. Each path
    runs once on the call's operands under the stand-in collectives (over
    stand-in groups of the ctx's axis sizes: no real collective is
    issued). A LOCAL call has nothing to certify. Certifications run one
    at a time; kernels and collectives that other threads call meanwhile
    run as they would unbound and leave nothing in the certificate."""
    from repro_torch.analysis import contracts
    if ir.dist is None or ir.dist.is_local:
        return
    sctx = contracts.standin_ctx(ir.dist)
    st = operands[ir.sparse_pos] if ir.sparse_pos is not None else None
    denses = [operands[i] for i in ir.dense_positions]
    family = _family_tag(ir)
    findings: List[Finding] = []
    for path in paths:
        findings += _analyze_execution(ir, path, st, denses, sctx, config,
                                       family, label=f"{ir.expr}/{path}")
    if findings:
        detail = "\n".join(f.format() for f in findings)
        raise SpmdContractError(
            f"SPMD certification failed for {ir.expr!r}: the plan's "
            f"collective schedule is unsound:\n{detail}")
