"""Plan dispatcher: lowers a chosen (IR, path) onto the kernel library and
the plain contractions, applying the collectives of the plan's AxisCtx
(identities: the port runs LOCAL only).

How each family lowers (every path of an IR computes the same einsum, so
forcing a path changes the schedule, never the result; tested in
``tests/test_torch_planner.py``):

* REDUCE → linearised kept-mode key + ``index_add_`` (any ordered subset of
  the modes; a trailing dense value axis rides along), or densified;
* TTTP → ``all_at_once``: ``kernels.ops.tttp``, the TTTP kernel;
  ``sliced``: ``core.tttp.tttp_sliced``, the TTTP kernel once per column
  slice (H = ``cost._sliced_h(R)``); ``pairwise``: ``core.tttp
  .tttp_pairwise``, plain; ``dense``: the dense multilinear model sampled
  per entry, plain;
* TTM → ``sparse.ops.ttm_dense_output`` / ``ttm_hypersparse``, or densified;
* MTTKRP, classic (one kept mode, factors on all others) →
  ``all_at_once`` **and** ``bucketed``: ``kernels.ops.mttkrp_bucketed``
  over the tensor's cached bucket view (``SparseTensor.row_buckets(mode,
  config.block_rows)``), the MTTKRP kernel; ``t_first`` / ``kr_first``:
  ``sparse.ops``'s pairwise forms, plain; ``dense``: densified;
* MTTKRP, partial (several kept modes) → ``all_at_once``: gather, product
  and ``index_add_`` over the linearised kept key, plain;
* CG_MATVEC (paper eq. 3) → ``fused``: ``kernels.ops.cg_matvec_bucketed``
  over the cached bucket view, the fused CG-matvec kernel;
  ``tttp_mttkrp`` / ``sliced``: ``kernels.ops.bucket_matvec``'s schedules
  over the same view (the TTTP kernel, then the MTTKRP kernel, H =
  ``_sliced_h`` column slices for ``sliced``); ``dense``: densified.

Classic ``all_at_once`` MTTKRP is where the port departs from the
reference. The cost model prices ``all_at_once`` and ``bucketed`` alike
and its tie order picks ``all_at_once``, which the reference lowers to a
plain gather + segment sum; lowered that way here, every default MTTKRP of
the solvers would leave the kernel for the library form (``index_add_``,
about 7x slower on the H100, ``PERF.md``). So both lower onto the bucketed
kernel; the ranking stays the reference's. ``sparse.ops.mttkrp`` keeps the
gather + ``index_add_`` form as the tests' second oracle.

``bucketed`` and ``fused`` never fall back: ``row_buckets`` builds the
pattern when ingest did not (the reference falls back under tracing, which
the port does not have). ``fused`` needs both halves of the matvec to share
their factors, as ``planned_cg_matvec`` always gives them; an einsum whose
two rank halves read different factors runs the ``tttp_mttkrp`` schedule.

The dense fallback contracts pairwise in a greedy order of its own
(:func:`greedy_einsum`): without ``opt_einsum`` ``torch.einsum`` contracts
left to right, which on the order-5, 11-operand CG matvec forms a tensor
the size of the full Khatri-Rao product.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import tttp as core_tttp
from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import linearize
from repro_torch.kernels import ops as kops
from repro_torch.planner import cost as pcost
from repro_torch.planner import ir as pir
from repro_torch.planner.config import PlannerConfig, default_config
from repro_torch.sparse import ops as sops


def _split_operands(ir: pir.ContractionIR, operands: Sequence):
    st = operands[ir.sparse_pos]
    dense_ops = [operands[i] for i in ir.dense_positions]
    return st, dense_ops


def _factors_by_mode(ir: pir.ContractionIR, dense_ops: Sequence[torch.Tensor]
                     ) -> List[Optional[torch.Tensor]]:
    """Length-N factor list with None at uncovered modes."""
    factors: List[Optional[torch.Tensor]] = [None] * len(ir.sparse.shape)
    for mode, f in zip(ir.factor_modes, dense_ops):
        factors[mode] = f
    return factors


def _reorder(res: torch.Tensor, canon: str, out: str) -> torch.Tensor:
    """Transpose a result with axis order ``canon`` into axis order ``out``."""
    if canon == out:
        return res
    return res.permute(tuple(canon.index(c) for c in out))


def greedy_einsum(expr: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(expr, *operands)`` contracted pairwise in a greedy
    order: at each step the pair whose result is smallest (ties to the
    first pair), each result keeping only the indices some other operand or
    the output still needs. Linear-time planning, near-optimal for the
    factor-matrix chains of the planner's families."""
    lhs, out = pir.normalize(expr).split("->")
    terms = lhs.split(",")
    ops = list(operands)
    sizes = {}
    for t, op in zip(terms, ops):
        sizes.update(zip(t, op.shape))
    while len(ops) > 1:
        best = None
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                rest = set(out).union(*(terms[k] for k in range(len(ops))
                                        if k not in (i, j)))
                keep = "".join(c for c in dict.fromkeys(terms[i] + terms[j])
                               if c in rest)
                size = math.prod(sizes[c] for c in keep)
                if best is None or size < best[0]:
                    best = (size, i, j, keep)
        _, i, j, keep = best
        res = torch.einsum(f"{terms[i]},{terms[j]}->{keep}", ops[i], ops[j])
        terms = [t for k, t in enumerate(terms) if k not in (i, j)] + [keep]
        ops = [o for k, o in enumerate(ops) if k not in (i, j)] + [res]
    return torch.einsum(f"{terms[0]}->{out}", ops[0])


def _densified_einsum(ir: pir.ContractionIR, st: SparseTensor,
                      dense_ops: Sequence) -> torch.Tensor:
    """Dense fallback keeping the original operand order (the sparse
    operand need not be first)."""
    args: List = [None] * len(ir.operands)
    args[ir.sparse_pos] = st.todense()
    for pos, op in zip(ir.dense_positions, dense_ops):
        args[pos] = op
    return greedy_einsum(ir.expr, *args)


# ---------------------------------------------------------------------------
# per-kind executors
# ---------------------------------------------------------------------------

def _exec_reduce(ir: pir.ContractionIR, st: SparseTensor, path: str,
                 ctx: AxisCtx):
    if path == "dense" and st.dense_dim is None:
        return ctx.psum_data(_densified_einsum(ir, st, ()))
    # trailing-dense values ride along unreduced (reduce_mode semantics);
    # the densified fallback cannot express them, so it also lands here
    if not ir.keep_modes:
        return ctx.psum_data(st.sum())
    kept_shape = tuple(st.shape[d] for d in ir.keep_modes)
    vals = st.masked_values()
    out = torch.zeros((math.prod(kept_shape),) + vals.shape[1:],
                      dtype=vals.dtype, device=vals.device)
    out = out.index_add_(0, _kept_key(st, ir.keep_modes, kept_shape), vals)
    return ctx.psum_data(out.reshape(kept_shape + vals.shape[1:]))


def _kept_key(st: SparseTensor, keep_modes, kept_shape) -> torch.Tensor:
    """Row-major key of the kept modes per slot: the mode's own index for
    one kept mode (CCD++'s reductions, no extra pass over the indices),
    else linearised."""
    if len(keep_modes) == 1:
        return st.indices[:, keep_modes[0]]
    return linearize(st.indices[:, list(keep_modes)], kept_shape)


def _exec_tttp(ir: pir.ContractionIR, st: SparseTensor, dense_ops,
               path: str, ctx: AxisCtx):
    factors = _factors_by_mode(ir, dense_ops)
    if path == "all_at_once":
        res = kops.tttp(st, factors)
    elif path == "sliced":
        res = core_tttp.tttp_sliced(st, factors,
                                    pcost._sliced_h(ir.rank_size))
    elif path == "pairwise":
        res = core_tttp.tttp_pairwise(st, factors)
    elif path == "dense":
        # the dense multilinear model over the covered modes, sampled per
        # entry (gathering from a densified result would double-count
        # duplicate coordinates)
        s_term = ir.sparse_term
        covered = sorted(ir.factor_modes)
        model_out = "".join(s_term[d] for d in covered)
        terms = [ir.operands[i].term for i in ir.dense_positions]
        model = greedy_einsum(",".join(terms) + "->" + model_out, *dense_ops)
        vals = st.values * model[tuple(st.indices[:, d].long()
                                       for d in covered)]
        res = st.with_values(vals)
    else:
        raise ValueError(f"unknown TTTP path {path!r}")
    if ctx.model is not None:
        # values are linear in the per-column partial inner products, so
        # the psum over column slices applies to them directly
        res = res.with_values(ctx.psum_model(res.values))
    return res


def _exec_ttm(ir: pir.ContractionIR, st: SparseTensor, dense_ops, path: str,
              ctx: AxisCtx):
    (w,) = dense_ops
    mode = ir.contract_mode
    s_term = ir.sparse_term
    canon = ("".join(c for c in s_term if s_term.index(c) != mode)
             + ir.rank_index)
    if path == "dense_output":
        res = sops.ttm_dense_output(st, w, mode)
    elif path == "hypersparse":
        res = sops.ttm_hypersparse(st, w, mode).todense()
    elif path == "dense":
        return ctx.psum_data(_densified_einsum(ir, st, dense_ops))
    else:
        raise ValueError(f"unknown TTM path {path!r}")
    return ctx.psum_data(_reorder(res, canon, ir.out))


def _mttkrp_general(ir: pir.ContractionIR, st: SparseTensor,
                    factors: Sequence[Optional[torch.Tensor]]
                    ) -> torch.Tensor:
    """All-at-once partial MTTKRP with any kept-mode subset: gather factor
    rows, multiply, segment-sum over the linearised kept key."""
    prod = st.masked_values()[:, None]
    for d, f in enumerate(factors):
        if f is not None:
            prod = prod * f[st.indices[:, d]]
    kept_shape = tuple(st.shape[d] for d in ir.keep_modes)
    out = torch.zeros(math.prod(kept_shape), prod.shape[-1],
                      dtype=prod.dtype, device=prod.device)
    out = out.index_add_(0, _kept_key(st, ir.keep_modes, kept_shape), prod)
    return out.reshape(kept_shape + (prod.shape[-1],))


def bucketed_mttkrp(st: SparseTensor,
                    factors: Sequence[Optional[torch.Tensor]], mode: int,
                    block_rows: Optional[int] = None) -> torch.Tensor:
    """Classic MTTKRP onto ``mode`` by the MTTKRP kernel over ``st``'s
    cached bucket view at ``block_rows`` (default: the planner config's)."""
    block_rows = block_rows or default_config().block_rows
    return kops.mttkrp_bucketed(st.row_buckets(mode, block_rows), factors,
                                num_rows=st.shape[mode])


def _exec_mttkrp(ir: pir.ContractionIR, st: SparseTensor, dense_ops,
                 path: str, ctx: AxisCtx, config: PlannerConfig):
    if path == "dense":
        return ctx.psum_data(_densified_einsum(ir, st, dense_ops))
    factors = _factors_by_mode(ir, dense_ops)
    canon = ir.out.replace(ir.rank_index, "") + ir.rank_index
    if not pir.is_classic_mttkrp(ir):
        if path != "all_at_once":
            raise ValueError(f"path {path!r} requires the classic MTTKRP "
                             f"shape (one kept mode, all others contracted)")
        return ctx.psum_data(
            _reorder(_mttkrp_general(ir, st, factors), canon, ir.out))
    mode = ir.keep_modes[0]
    if path in ("all_at_once", "bucketed"):
        res = bucketed_mttkrp(st, factors, mode, config.block_rows)
    elif path == "t_first":
        res = sops.mttkrp_pairwise_t_first(st, factors, mode)
    elif path == "kr_first":
        res = sops.mttkrp_pairwise_kr_first(st, factors, mode)
    else:
        raise ValueError(f"unknown MTTKRP path {path!r}")
    return ctx.psum_data(_reorder(res, canon, ir.out))


def _cg_factor_groups(ir: pir.ContractionIR, dense_ops: Sequence):
    """Split the CG_MATVEC dense operands into the kept-rank (MTTKRP half)
    and contracted-rank (TTTP half) factor lists, indexed by sparse mode."""
    nd = len(ir.sparse.shape)
    s_term = ir.sparse_term
    r_fac: List[Optional[torch.Tensor]] = [None] * nd
    s_fac: List[Optional[torch.Tensor]] = [None] * nd
    for pos, op in zip(ir.dense_positions, dense_ops):
        t = ir.operands[pos].term
        d = s_term.index(t[0])
        if t[1] == ir.rank_index:
            r_fac[d] = op
        else:
            s_fac[d] = op
    return r_fac, s_fac


def _exec_cg_matvec(ir: pir.ContractionIR, st: SparseTensor, dense_ops,
                    path: str, ctx: AxisCtx, config: PlannerConfig):
    """Weighted Gram matvec (paper eq. 3): the values of ``st`` are the
    weights ω_n, ``s_fac[mode]`` is the CG direction x. Every path but
    ``dense`` runs ``kernels.ops.bucket_matvec`` over the cached bucket
    view of ``st``."""
    if path == "dense":
        return ctx.psum_data(_densified_einsum(ir, st, dense_ops))
    if path not in kops.BUCKET_MATVEC_PATHS:
        raise ValueError(f"unknown CG_MATVEC path {path!r}")
    mode = ir.keep_modes[0]
    r_fac, s_fac = _cg_factor_groups(ir, dense_ops)
    x = s_fac[mode]
    shared = all(s_fac[d] is r_fac[d] for d in range(len(r_fac))
                 if d != mode)
    canon = ir.sparse_term[mode] + ir.rank_index
    sliced = path == "sliced"
    res = kops.bucket_matvec(
        st.row_buckets(mode, config.block_rows), r_fac, x,
        "tttp_mttkrp" if path == "fused" and not shared else path,
        h_slices=pcost._sliced_h(ir.rank_size) if sliced else 1,
        x_factors=None if shared else s_fac,
        x_slices=(pcost._sliced_h(ir.size_of(ir.rank2_index)) if sliced
                  else 1))
    return ctx.psum_data(_reorder(res, canon, ir.out))


def _tensors(out):
    return out.values if isinstance(out, SparseTensor) else out


def execute(ir: pir.ContractionIR, path: str, operands: Sequence,
            ctx: Optional[AxisCtx] = None,
            config: Optional[PlannerConfig] = None):
    """Run the contraction along ``path``. The operand list must match the
    IR; ``ctx`` supplies the axes whose collectives dispatch applies (None
    means LOCAL).

    With ``obs`` enabled and no CUDA graph being captured, each execution
    records a span ``planner/<kind>/<path>`` and a predicted-against-
    measured plan entry: the §5.3 flop/traffic/comm prediction for this
    (IR, path) beside the wall time fenced by a device synchronisation.
    With ``obs`` off (the default) nothing is recorded and nothing waits
    for the device."""
    if not (obs.enabled() and obs.trace_clean()):
        return _execute(ir, path, operands, ctx, config)
    kind = str(ir.kind)
    nnz, rank = ((ir.nnz, ir.rank_size) if ir.sparse_pos is not None
                 else (0, 0))
    with obs.span(f"planner/{kind}/{path}", expr=ir.expr, nnz=nnz,
                  rank=rank):
        t0 = time.perf_counter()
        out = _execute(ir, path, operands, ctx, config)
        obs.synchronize(_tensors(out))
        seconds = time.perf_counter() - t0
    c = pcost.estimate(ir, path)
    obs.get_registry().record_plan(
        f"{ir.expr}|{path}|m{nnz}|r{rank}", kind, path, ir.expr,
        {"flops": c.flops, "mem": c.mem, "comm": c.comm,
         "seconds": c.seconds}, seconds)
    return out


def _execute(ir: pir.ContractionIR, path: str, operands: Sequence,
             ctx: Optional[AxisCtx], config: Optional[PlannerConfig]):
    ctx = ctx if ctx is not None else LOCAL
    config = config if config is not None else default_config()
    if ir.kind == pir.DENSE:
        return torch.einsum(ir.expr, *operands)
    st, dense_ops = _split_operands(ir, operands)
    if ir.kind == pir.REDUCE:
        return _exec_reduce(ir, st, path, ctx)
    if ir.kind == pir.TTTP:
        return _exec_tttp(ir, st, dense_ops, path, ctx)
    if ir.kind == pir.TTM:
        return _exec_ttm(ir, st, dense_ops, path, ctx)
    if ir.kind == pir.MTTKRP:
        return _exec_mttkrp(ir, st, dense_ops, path, ctx, config)
    if ir.kind == pir.CG_MATVEC:
        return _exec_cg_matvec(ir, st, dense_ops, path, ctx, config)
    raise ValueError(f"unknown IR kind {ir.kind!r}")
