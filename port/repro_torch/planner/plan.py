"""Plan construction, caching and optional one-shot autotuning.

A :class:`Plan` binds a classified :class:`~repro_torch.planner.ir
.ContractionIR` to a chosen execution path, with the full cost ranking
attached. Plans are cached on the *static signature* of the call:

    (normalised expr, per-operand (kind, shape, cap, nnz, dtype, device),
     override, AxisCtx, PlannerConfig)

so planning happens once per (expression, operand layout, device) and
identical calls return the *identical* Plan object. The key is built from
Python metadata alone (``SparseTensor.nnz`` is a Python int), so a cached
call costs one dictionary lookup and never waits for the device.

While a CUDA graph is being captured (the port's counterpart of the
reference's jax trace) nothing is planned, timed or recorded: a call there
must find its plan in the cache, built by the same call run eagerly first,
as the serving engine's first call of a key does.

``autotune=True`` upgrades a plan by timing every candidate within
:data:`AUTOTUNE_MEM_BUDGET_WORDS` on the given operands (:func:`fenced_time`,
best of 3 after a warm-up) and pinning the measured winner; the timings are
kept on the plan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.planner import cost as pcost
from repro_torch.planner import dispatch as pdispatch
from repro_torch.planner import ir as pir
from repro_torch.planner.config import (DEFAULT_CONFIG, PlannerConfig,
                                        default_config)


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
               ctx: AxisCtx, config: PlannerConfig) -> Tuple:
    sig = []
    for op in operands:
        if isinstance(op, SparseTensor):
            sig.append(("sparse", tuple(op.shape), op.cap, op.nnz,
                        op.values.dtype, op.dense_dim, op.nnz_rows,
                        op.device))
        else:
            sig.append(("dense", tuple(op.shape), op.dtype, op.device))
    return (pir.normalize(expr), tuple(sig), path, ctx, config)


_CACHE: Dict[Tuple, Plan] = {}

# candidates whose estimated memory traffic exceeds this (in words) are not
# timed during autotuning: 16 GiB of float32, a fifth of the H100's 80 GB
# (the dense and KR-first fallbacks explode at low density)
AUTOTUNE_MEM_BUDGET_WORDS = 2 ** 32


def clear_plan_cache() -> None:
    _CACHE.clear()


def plan_cache_size() -> int:
    return len(_CACHE)


def _sync(out) -> None:
    obs.synchronize(out.values if isinstance(out, SparseTensor) else out)


def fenced_time(fn, iters: int = 3, span_name: str = "tuner/measure",
                **attrs) -> float:
    """Best-of-``iters`` wall time of ``fn()`` after one warm-up call, each
    run fenced by a synchronisation of the devices its output lies on
    (``torch.cuda.synchronize``; nothing to wait for on the CPU). Every
    timed run sits in an ``obs.span``, so with tracing on the timings land
    in the registry beside the planner's spans."""
    _sync(fn())
    best = float("inf")
    for _ in range(iters):
        with obs.span(span_name, **attrs):
            t0 = time.perf_counter()
            _sync(fn())
            best = min(best, time.perf_counter() - t0)
    return best


def _time_path(ir: pir.ContractionIR, path: str, operands: Sequence,
               ctx: AxisCtx, config: PlannerConfig, iters: int = 3) -> float:
    def run():
        return pdispatch.execute(ir, path, operands, ctx=ctx, config=config)
    return fenced_time(run, iters=iters, span_name=f"planner/autotune/{path}",
                       kind=str(ir.kind), expr=ir.expr)


def _check_local(ctx: AxisCtx, rowsharded: bool) -> None:
    """The port runs LOCAL only: refuse what would distribute."""
    if rowsharded:
        raise NotImplementedError(
            "rowsharded=True (factor rows sharded over the data axes, paper "
            "Fig. 2) is distribution, ROADMAP.md Queue A item 4; the port "
            "runs on one device")
    if ctx.data_size() != 1 or ctx.model_size() != 1 or \
            ctx.model is not None:
        raise NotImplementedError(
            f"a non-LOCAL ctx ({ctx!r}) is distribution, ROADMAP.md Queue A "
            f"item 4; the port runs on one device")


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

    Refused with a message, never ignored: ``validate=True`` (the
    reference's abstract all-paths-agree certificate, ``ROADMAP.md`` Queue A
    item 5, the static gates), ``validate_spmd=True`` (a check of jax's
    collective schedule, item 5), and a non-LOCAL ``ctx``,
    ``rowsharded=True`` or ``path="rowsharded"`` (distribution, item 4).
    """
    if validate:
        raise NotImplementedError(
            "validate=True: the all-paths-agree certificate is part of the "
            "static gates, ROADMAP.md Queue A item 5, not ported yet")
    if validate_spmd:
        raise NotImplementedError(
            "validate_spmd=True certifies a jax collective schedule; the "
            "port's counterpart is ROADMAP.md Queue A item 5")
    if path == "rowsharded":
        raise NotImplementedError(
            "path='rowsharded' is distribution, ROADMAP.md Queue A item 4; "
            "the port runs on one device")
    ctx = ctx if ctx is not None else LOCAL
    _check_local(ctx, rowsharded)
    config = config if config is not None else default_config()
    key = _signature(expr, operands, path, ctx, config)
    cached = _CACHE.get(key)
    capturing = not obs.trace_clean()
    if cached is not None and (path is not None or cached.autotuned
                               or not autotune or capturing):
        return cached
    if capturing:
        raise RuntimeError(
            f"no cached plan for {pir.normalize(expr)!r} while a CUDA graph "
            f"is being captured: run the same call once eagerly first")

    ir = pir.build_ir(expr, operands)
    ranking = pcost.rank_paths(ir)
    candidates = tuple(c.path for c in ranking)
    if path is not None:
        # a forced path makes autotuning moot: the plan is final
        if path not in candidates:
            raise ValueError(f"path {path!r} not legal for {expr!r}; "
                             f"candidates: {candidates}")
        plan = Plan(ir, path, ranking, ctx=ctx, config=config)
    elif autotune:
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
