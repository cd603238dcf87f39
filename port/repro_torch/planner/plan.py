"""Plan construction, caching and optional one-shot autotuning.

A :class:`Plan` binds a classified :class:`~repro_torch.planner.ir
.ContractionIR` to a chosen execution path, with the full cost ranking
attached. Plans are cached on the *static signature* of the call:

    (normalised expr, per-operand (kind, shape, cap, nnz, dtype, device),
     override, AxisCtx, DistInfo, PlannerConfig)

so planning happens once per (expression, operand layout, device,
distribution) and
identical calls return the *identical* Plan object. The key is built from
Python metadata alone (``SparseTensor.nnz`` is a Python int), so a cached
call costs one dictionary lookup and never waits for the device.

While a CUDA graph is being captured (the port's counterpart of the
reference's jax trace) nothing is planned, timed or recorded: a call there
must find its plan in the cache, built by the same call run eagerly first,
as the serving engine's first call of a key does.

``autotune=True`` upgrades a plan by timing every candidate within
:data:`AUTOTUNE_MEM_BUDGET_WORDS` on the given operands
(``tuner.fenced_time``, best of 3 after a warm-up) and pinning the measured
winner; the timings are kept on the plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.planner import cost as pcost
from repro_torch.planner import dispatch as pdispatch
from repro_torch.planner import ir as pir
from repro_torch.planner.config import (DEFAULT_CONFIG, PlannerConfig,
                                        default_config)
from repro_torch.planner.tuner import fenced_time


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable contraction plan (immutable; shared via the cache)."""
    ir: pir.ContractionIR
    path: str
    ranking: Tuple[pcost.PathCost, ...]   # all candidates, cheapest first
    autotuned: bool = False
    timings: Optional[Tuple[Tuple[str, float], ...]] = None  # (path, seconds)
    ctx: AxisCtx = LOCAL
    config: PlannerConfig = DEFAULT_CONFIG

    @property
    def candidates(self) -> Tuple[str, ...]:
        return tuple(c.path for c in self.ranking)

    def cost(self, path: Optional[str] = None) -> pcost.PathCost:
        path = path or self.path
        for c in self.ranking:
            if c.path == path:
                return c
        raise KeyError(path)

    def execute(self, operands: Sequence):
        return pdispatch.execute(self.ir, self.path, operands,
                                 ctx=self.ctx, config=self.config)


def _signature(expr: str, operands: Sequence, path: Optional[str],
               ctx: AxisCtx, dist: Optional[pir.DistInfo],
               config: PlannerConfig) -> Tuple:
    sig = []
    for op in operands:
        if isinstance(op, SparseTensor):
            sig.append(("sparse", tuple(op.shape), op.cap, op.nnz,
                        op.values.dtype, op.dense_dim, op.nnz_rows,
                        op.device))
        else:
            sig.append(("dense", tuple(op.shape), op.dtype, op.device))
    return (pir.normalize(expr), tuple(sig), path, ctx, dist, config)


_CACHE: Dict[Tuple, Plan] = {}

# candidates whose estimated memory traffic exceeds this (in words) are not
# timed during autotuning: 16 GiB of float32, a fifth of the H100's 80 GB
# (the dense and KR-first fallbacks explode at low density)
AUTOTUNE_MEM_BUDGET_WORDS = 2 ** 32


def clear_plan_cache() -> None:
    _CACHE.clear()


def plan_cache_size() -> int:
    return len(_CACHE)


def _time_path(ir: pir.ContractionIR, path: str, operands: Sequence,
               ctx: AxisCtx, config: PlannerConfig, iters: int = 3) -> float:
    def run():
        return pdispatch.execute(ir, path, operands, ctx=ctx, config=config)
    return fenced_time(run, iters=iters, span_name=f"planner/autotune/{path}",
                       kind=str(ir.kind), expr=ir.expr)


def _dist_info(ctx: AxisCtx, rowsharded: bool) -> Optional[pir.DistInfo]:
    """Static distribution signature of a ctx (host ints): None when the
    call runs as on one device."""
    data = ctx.data_size()
    model = ctx.model_size()
    if data == 1 and model == 1 and not rowsharded:
        return None
    return pir.DistInfo(data, model, rowsharded)


def plan_contraction(expr: str, operands: Sequence,
                     path: Optional[str] = None,
                     autotune: bool = False,
                     ctx: AxisCtx = LOCAL,
                     rowsharded: bool = False,
                     config: Optional[PlannerConfig] = None,
                     validate: bool = False,
                     validate_spmd: bool = False) -> Plan:
    """Plan (or fetch the cached plan for) one einsum call.

    ``path`` forces a specific candidate (checked against the IR);
    ``autotune`` measures the candidates once and pins the winner;
    ``config`` fixes the bucket granularity the bucketed and fused paths
    read (default: :func:`~repro_torch.planner.config.default_config`).

    ``ctx`` names the axes the call runs under: the cost model adds the
    matching collectives and dispatch applies them; ``rowsharded``
    declares the dense factors' ROWS sharded over the data axes (paper
    Fig. 2), whose only candidate is ``rowsharded``.

    ``validate=True`` certifies a NEW plan before it enters the cache
    (``analysis.contracts.certify_candidates``): every candidate path runs
    once on these operands and must give the same output structure, shape,
    dtype and device, else ``PlanContractError``; a cached plan is returned
    as it is. ``validate_spmd=True`` certifies a NEW plan's collective
    schedule before it enters the cache
    (``analysis.spmd.sharding.certify_plan``): every candidate path runs
    once on these operands under the sharding interpreter, with stand-in
    collectives over the ctx's axis sizes, and must leave no partial sum
    unreduced, psum nothing twice and gather no global rows from a
    row-sharded factor, else ``SpmdContractError``; a LOCAL call has
    nothing to certify, and a cached plan is returned as it is.
    """
    ctx = ctx if ctx is not None else LOCAL
    config = config if config is not None else default_config()
    # the axis SIZES go into the key beside the ctx's names
    dist = _dist_info(ctx, rowsharded)
    key = _signature(expr, operands, path, ctx, dist, config)
    cached = _CACHE.get(key)
    capturing = not obs.trace_clean()
    if cached is not None and (path is not None or cached.autotuned
                               or not autotune or capturing):
        return cached
    if capturing:
        raise RuntimeError(
            f"no cached plan for {pir.normalize(expr)!r} while a CUDA graph "
            f"is being captured: run the same call once eagerly first")

    ir = pir.build_ir(expr, operands, dist=dist)
    ranking = pcost.rank_paths(ir)
    candidates = tuple(c.path for c in ranking)
    if validate:
        # here, not at the top: the analysis package imports the planner
        from repro_torch.analysis.contracts import certify_candidates
        certify_candidates(ir, candidates, operands, ctx, config)
    if validate_spmd:
        from repro_torch.analysis.spmd.sharding import certify_plan
        certify_plan(ir, candidates, operands, ctx, config)
    if path is not None:
        # a forced path makes autotuning moot: the plan is final
        if path not in candidates:
            raise ValueError(f"path {path!r} not legal for {expr!r}; "
                             f"candidates: {candidates}")
        plan = Plan(ir, path, ranking, ctx=ctx, config=config)
    elif autotune:
        if dist is not None:
            raise ValueError(
                "autotune=True under a distributed ctx: each rank would time "
                "the candidates on its own and could pin another path; force "
                "one with path= instead")
        feasible = [c.path for c in ranking
                    if c.mem <= AUTOTUNE_MEM_BUDGET_WORDS]
        if not feasible:
            feasible = [ranking[0].path]
        timings = tuple((p, _time_path(ir, p, operands, ctx, config))
                        for p in feasible)
        winner = min(timings, key=lambda t: t[1])[0]
        plan = Plan(ir, winner, ranking, autotuned=True, timings=timings,
                    ctx=ctx, config=config)
    else:
        plan = Plan(ir, ranking[0].path, ranking, ctx=ctx, config=config)
    _CACHE[key] = plan
    return plan
