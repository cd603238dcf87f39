"""Sparse einsum planner: cost-model-driven contraction paths with plan
caching and kernel dispatch (paper §5.3).

Layering::

    ir.py        einsum IR: parse and classify into contraction families
    cost.py      the paper's §5.3 flop/memory formulas per candidate path
    plan.py      ranking, plan cache, one-shot autotuning
    dispatch.py  lowering onto the CUDA kernels and the plain contractions
    config.py    bucket granularity and H-slicing knobs of dispatch

``repro_torch.core.api.einsum`` and ``api.TTTP`` are thin shims over
:func:`planned_einsum`; the completion solvers' contraction shims
(``core.distributed``) run through :func:`planned_tttp`,
:func:`planned_mttkrp` and :func:`planned_reduce`, and their ``path=``
overrides force a candidate.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.planner import config as _pconfig
from repro_torch.planner.config import (DEFAULT_CONFIG, PlannerConfig,
                                        default_config, set_default_config)
from repro_torch.planner.cost import (PathCost, candidate_paths, estimate,
                                      rank_paths)
from repro_torch.planner.dispatch import bucketed_mttkrp, execute
from repro_torch.planner.ir import ContractionIR, DistInfo, build_ir
from repro_torch.planner.plan import (Plan, clear_plan_cache,
                                      plan_cache_size, plan_contraction)

__all__ = [
    "ContractionIR", "DistInfo", "PathCost", "Plan", "PlannerConfig",
    "DEFAULT_CONFIG", "default_config", "set_default_config",
    "build_ir", "candidate_paths", "estimate", "rank_paths",
    "plan_contraction", "clear_plan_cache", "plan_cache_size",
    "execute", "planned_einsum", "planned_mttkrp",
    "planned_tttp", "planned_cg_matvec", "planned_reduce",
    "mttkrp_fn", "tttp_fn",
]

# mode letters for synthesized expressions; 'z' is reserved for the kept
# rank, 'y' for the contracted rank of the Gram-matvec family
_MODE_LETTERS = "abcdefghij"
_RANK_LETTER = "z"
_RANK2_LETTER = "y"


def mttkrp_fn(path: Optional[str] = None,
              config: Optional[PlannerConfig] = None):
    """The solvers' opt-in seam: ``None`` returns the direct kernel (the
    bucketed MTTKRP over the tensor's cached view, no planning); a path
    string returns a drop-in pinned to that planner path. Same
    ``(st, factors, mode)`` signature either way."""
    if path is None:
        cfg = config or _pconfig.default_config()
        return functools.partial(bucketed_mttkrp, block_rows=cfg.block_rows)
    return functools.partial(planned_mttkrp, path=path, config=config)


def tttp_fn(path: Optional[str] = None):
    """As :func:`mttkrp_fn` for TTTP: ``None`` gives ``kernels.ops.tttp``,
    a path string planner dispatch pinned to it."""
    if path is None:
        from repro_torch.kernels import ops as kops
        return kops.tttp
    return functools.partial(planned_tttp, path=path)


def planned_einsum(expr: str, *operands, path: Optional[str] = None,
                   plan: Optional[Plan] = None, autotune: bool = False,
                   ctx: AxisCtx = LOCAL, rowsharded: bool = False,
                   config: Optional[PlannerConfig] = None,
                   device="cuda"):
    """Einsum through the planner; ``path=`` forces a candidate, ``plan=``
    bypasses planning (the caller owns signature compatibility).

    A pure-dense call has nothing to plan and goes to ``torch.einsum``;
    like ``jnp.einsum`` it accepts lists and scalars, made tensors on
    ``device`` (default ``cuda``; tensor operands keep their own device)."""
    if plan is None:
        if not any(isinstance(op, SparseTensor) for op in operands):
            ops = [op if isinstance(op, torch.Tensor)
                   else torch.as_tensor(op, device=device) for op in operands]
            return torch.einsum(expr, *ops)
        plan = plan_contraction(expr, operands, path=path, autotune=autotune,
                                ctx=ctx, rowsharded=rowsharded, config=config)
    return plan.execute(operands)


def _synth_expr(ndim: int, factor_modes: Sequence[int], out: str) -> str:
    s_term = _MODE_LETTERS[:ndim]
    terms = [s_term] + [s_term[d] + _RANK_LETTER for d in factor_modes]
    return ",".join(terms) + "->" + out


def planned_mttkrp(st: SparseTensor,
                   factors: Sequence[Optional[torch.Tensor]], mode: int,
                   path: Optional[str] = None, autotune: bool = False,
                   ctx: AxisCtx = LOCAL, rowsharded: bool = False,
                   h_slices: int = 1,
                   config: Optional[PlannerConfig] = None) -> torch.Tensor:
    """Classic MTTKRP onto ``mode`` through the planner (drop-in for
    ``sparse.ops.mttkrp``). ``factors[mode]`` is ignored."""
    present = [d for d in range(st.ndim)
               if d != mode and factors[d] is not None]
    expr = _synth_expr(st.ndim, present, _MODE_LETTERS[mode] + _RANK_LETTER)
    ops = (st, *[factors[d] for d in present])
    if h_slices != 1:
        config = (config or _pconfig.default_config()).with_h_slices(h_slices)
    return planned_einsum(expr, *ops, path=path, autotune=autotune,
                          ctx=ctx, rowsharded=rowsharded, config=config)


def planned_reduce(st: SparseTensor, keep_modes: Tuple[int, ...],
                   path: Optional[str] = None,
                   ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """Sparse mode-subset reduction through the planner (drop-in for
    ``SparseTensor.reduce_mode``, psum over the data axes)."""
    s_term = _MODE_LETTERS[:st.ndim]
    expr = s_term + "->" + "".join(s_term[d] for d in keep_modes)
    return planned_einsum(expr, st, path=path, ctx=ctx)


def planned_cg_matvec(weights: SparseTensor,
                      factors: Sequence[torch.Tensor], mode: int,
                      x: torch.Tensor, path: Optional[str] = None,
                      autotune: bool = False, ctx: AxisCtx = LOCAL,
                      config: Optional[PlannerConfig] = None
                      ) -> torch.Tensor:
    """Weighted Gram matvec (paper §2.2 + eq. 3) through the planner:

        y[i, r] = Σ_{n: i_mode(n)=i} ω_n (Π_{d≠mode} A_d[i_d, r]) ·
                  Σ_s x[i, s] Π_{d≠mode} A_d[i_d, s]

    ``weights.values`` holds ω_n (the Ω indicator for plain ALS, the loss
    curvature for Gauss-Newton). Candidates: ``fused`` (the fused CG-matvec
    kernel), ``tttp_mttkrp`` (TTTP then MTTKRP), ``sliced`` (both halves
    H-sliced), ``dense``. The λ term is not included: callers add
    ``lam * x``."""
    nd = weights.ndim
    others = [d for d in range(nd) if d != mode]
    if any(factors[d] is None for d in others):
        raise ValueError("the Gram matvec needs a factor on every "
                         "non-target mode")
    s_term = _MODE_LETTERS[:nd]
    terms = ([s_term]
             + [s_term[d] + _RANK_LETTER for d in others]
             + [s_term[mode] + _RANK2_LETTER]
             + [s_term[d] + _RANK2_LETTER for d in others])
    expr = ",".join(terms) + "->" + s_term[mode] + _RANK_LETTER
    ops = (weights, *[factors[d] for d in others], x,
           *[factors[d] for d in others])
    return planned_einsum(expr, *ops, path=path, autotune=autotune,
                          ctx=ctx, config=config)


def planned_tttp(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
                 path: Optional[str] = None, autotune: bool = False,
                 ctx: AxisCtx = LOCAL, rowsharded: bool = False,
                 h_slices: int = 1,
                 config: Optional[PlannerConfig] = None) -> SparseTensor:
    """TTTP through the planner (drop-in for ``core.tttp.tttp``): accepts
    None entries and vector factors, per the paper's Listing 3 surface."""
    fs: List[Optional[torch.Tensor]] = [
        None if f is None else (f[:, None] if f.dim() == 1 else f)
        for f in factors]
    present = [d for d in range(st.ndim) if fs[d] is not None]
    if not present:
        raise ValueError("TTTP requires at least one factor")
    expr = _synth_expr(st.ndim, present, _MODE_LETTERS[:st.ndim])
    ops = (st, *[fs[d] for d in present])
    if h_slices != 1:
        config = (config or _pconfig.default_config()).with_h_slices(h_slices)
    return planned_einsum(expr, *ops, path=path, autotune=autotune,
                          ctx=ctx, rowsharded=rowsharded, config=config)
