"""ALS for tensor completion with implicit batched conjugate gradient (paper
§2.2), plus the explicit Gram-forming baseline it improves upon.

For each mode, solve the I independent R×R SPD systems
    (G^(i) + λI) u_i = b_i,   b = MTTKRP(T, factors)
without forming G^(i). The batched matvec (paper eq. 3) is

    Y = MTTKRP( TTTP(Ω, [..., X at mode, ...]), factors ) + λX

run either as one fused pass over the Ω buckets (``matvec_path="fused"``,
the fused CG-matvec kernel) or as the TTTP kernel followed by the bucketed
MTTKRP kernel (``"tttp_mttkrp"``), both over Ω's cached bucket view. Both
take any rank: ``kernels.ops.cg_matvec_bucketed`` runs R above the fused
kernel's width as TTTP then MTTKRP. ``h_slices > 1`` is the paper's
H-sliced schedule (the reference's route when no ``matvec_path`` is given):
both halves over Ω's bucket view, R cut into column slices of ⌈R/H⌉. The
planner's candidates (``auto``, ``sliced``, ``dense``) run the matvec
through ``planner.planned_cg_matvec``, and ``mttkrp_path`` forces the
MTTKRP contractions onto a planner candidate.

CG stops at the first iteration in which no row is still active, as the
reference's ``while_loop`` does: one host read of that flag an iteration,
the only wait a CG step has. Converged rows are frozen by masks before
then (``alpha = beta = 0`` leaves x and r exactly unchanged), so the
factors are those of the full budget, bit for bit. Where a fixed launch
sequence is needed (the caller's ``out`` buffers, which fold-in's CUDA
graphs replay, or a graph being captured) the loop runs all ``max_iters``
iterations with no host read. The count of iterations in which some row
was still active stays on the device; while tracing is live, outside
graph capture, each solve adds the iterations it ran and that count to the
``obs`` counters ``cg/iterations`` and ``cg/active_iterations``, and one
to ``cg/early_exits`` when it stopped before its budget. A mode's update
runs in the device-timed spans ``als/rhs`` (the right-hand side's MTTKRP)
and ``als/cg``.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core.distributed import (LOCAL, AxisCtx, mttkrp_ctx,
                                          planner_config, rowdot_ctx)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops as kops

# the Gram matvec's routes: the two direct ones, and the planner's
# candidates (``auto``: the §5.3 cost model picks; at the solvers' shapes it
# picks ``fused``)
DIRECT_MATVEC_PATHS = ("fused", "tttp_mttkrp")
MATVEC_PATHS = ("auto",) + DIRECT_MATVEC_PATHS + ("sliced", "dense")


def gram_matvec(omega: SparseTensor, factors: Sequence[torch.Tensor],
                mode: int, x: torch.Tensor, lam: float,
                ctx: AxisCtx = LOCAL, h_slices: int = 1,
                matvec_path: str = "fused",
                block_rows: int = 8,
                mttkrp_path: Optional[str] = None) -> torch.Tensor:
    """(G_ω + λI) x via the implicit eq.-3 matvec. ``omega.values`` are the
    per-entry weights ω_n: the Ω indicator for plain ALS, the loss
    curvature for the Gauss-Newton solver (``completion.gauss_newton``).

    ``matvec_path`` ``fused`` and ``tttp_mttkrp`` are the direct routes
    over Ω's bucket view (``kernels.ops.bucket_matvec``); ``auto``,
    ``sliced`` and ``dense`` run the whole matvec through the planner's
    ``cg_matvec`` family (``planner.planned_cg_matvec``), as the
    reference's ``matvec_path`` does. ``mttkrp_path`` forces the MTTKRP
    half onto a planner candidate: the matvec then runs as TTTP over the
    bucket view followed by that MTTKRP, ``h_slices`` column slices on
    both halves.

    Under a model axis the TTTP half's partial needs a psum over it before
    the MTTKRP half, which one fused pass cannot hold: ``fused`` and
    ``dense`` step down to the cost model's choice (``auto``), as in the
    reference, and ``tttp_mttkrp`` psums z between its halves."""
    if matvec_path not in MATVEC_PATHS:
        raise ValueError(f"matvec_path {matvec_path!r} not in {MATVEC_PATHS}")
    if ctx.model is not None and (
            matvec_path == "dense" or (matvec_path == "fused"
                                       and mttkrp_path is None
                                       and h_slices == 1)):
        matvec_path = "auto"
    if matvec_path not in DIRECT_MATVEC_PATHS:
        from repro_torch.planner import planned_cg_matvec
        y = planned_cg_matvec(
            omega, list(factors), mode, x,
            path=None if matvec_path == "auto" else matvec_path, ctx=ctx,
            config=planner_config(block_rows))
        return y + lam * x
    mttkrp = (None if mttkrp_path is None
              else _planned_mttkrp(mttkrp_path, block_rows))
    return ctx.psum_data(kops.bucket_matvec(
        omega.row_buckets(mode, block_rows), factors, x, matvec_path,
        h_slices, mttkrp=mttkrp,
        psum_model=ctx.psum_model if ctx.model is not None else None)) \
        + lam * x


def bucket_gram_matvec(buckets, factors: Sequence[torch.Tensor],
                       x: torch.Tensor, lam: float, ctx: AxisCtx = LOCAL,
                       matvec_path: str = "fused") -> torch.Tensor:
    """:func:`gram_matvec` over a bucket view of Ω (``RowBlockBuckets``,
    its values the weights ω) along ``buckets.mode``."""
    return ctx.psum_data(kops.bucket_matvec(buckets, factors, x,
                                            matvec_path)) + lam * x


def _planned_mttkrp(path: str, block_rows: int):
    """The MTTKRP half of ``kernels.ops.bucket_matvec`` pinned to the
    planner candidate ``path``, run on the bucket view as it is
    (``SparseTensor.from_buckets``: no second bucketing)."""
    from repro_torch.planner import mttkrp_fn
    mv = mttkrp_fn(path, planner_config(block_rows))
    return lambda zb, fs: mv(SparseTensor.from_buckets(zb), fs, zb.mode)


def batched_pcg(matvec, b: torch.Tensor, x0: torch.Tensor, precond=None,
                tol: float = 1e-4, max_iters: int = 32,
                ctx: AxisCtx = LOCAL, out=None):
    """Preconditioned batched-rows CG on SPD systems; rows converge
    independently and converged rows (residual² ≤ tol²·‖b_row‖²) are frozen
    by masking. Stops before the matvec of the first iteration in which no
    row is active, so the matvec runs 1 + ``iters`` times; with ``out``
    given, or under graph capture, runs all ``max_iters`` (see the module
    docstring). Returns ``(x, iters)`` with ``iters`` a device tensor: the
    iterations in which some row was active, the reference's trip count.
    ``out`` (x of x0's shape, a 0-d int32 count) receives both, the last
    step writing x into it: the same launches, into the caller's buffers.

    Under a data or model axis every rank leaves on the same iteration, as
    the collectives inside the next matvec need: ``rs`` is psummed over
    the model axis and the matvec over the data axis, so every rank holds
    the same bits and reads the same flag, with no collective of its own."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    early_exit = out is None and not obs.capturing()
    bnorm2 = rowdot_ctx(b, b, ctx)
    thresh = (tol ** 2) * torch.clamp(bnorm2, min=1e-30)
    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = rowdot_ctx(r, z, ctx)
    rs = rowdot_ctx(r, r, ctx)
    if out is None:
        iters = torch.zeros((), dtype=torch.int32, device=b.device)
    else:
        iters = out[1].zero_()
        if max_iters == 0:
            x = out[0].copy_(x0)
    ran = 0
    for k in range(max_iters):
        active = rs > thresh
        any_active = active.any()
        # the one host read a CG iteration waits for
        if early_exit and not bool(any_active):
            break
        iters += any_active
        ran += 1
        ap = matvec(p)
        pap = rowdot_ctx(p, ap, ctx)
        alpha = torch.where(active, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        if out is not None and k == max_iters - 1:
            x = torch.add(x, alpha[:, None] * p, out=out[0])
        else:
            x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = precond(r)
        rz_new = rowdot_ctx(r, z, ctx)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0),
                           0.0)
        p = z + beta[:, None] * p
        rz = rz_new
        rs = rowdot_ctx(r, r, ctx)
    obs.counter_add("cg/iterations", ran)
    obs.counter_add("cg/active_iterations", iters)
    if ran < max_iters:
        obs.counter_add("cg/early_exits", 1)
    return x, iters


def batched_cg(matvec, b: torch.Tensor, x0: torch.Tensor, tol: float = 1e-4,
               max_iters: int = 32, ctx: AxisCtx = LOCAL, out=None):
    """Unpreconditioned :func:`batched_pcg`."""
    return batched_pcg(matvec, b, x0, precond=None, tol=tol,
                       max_iters=max_iters, ctx=ctx, out=out)


def als_update_mode(st: SparseTensor, omega: SparseTensor,
                    factors: List[torch.Tensor], mode: int, lam: float,
                    cg_tol: float = 1e-4, cg_iters: int = 32,
                    ctx: AxisCtx = LOCAL, h_slices: int = 1,
                    matvec_path: str = "fused",
                    block_rows: int = 8,
                    mttkrp_path: Optional[str] = None) -> torch.Tensor:
    """One ALS factor update by implicit CG: b from the MTTKRP (the bucketed
    kernel unless ``mttkrp_path`` forces a planner candidate), then
    ``cg_iters`` batched CG steps on the eq.-3 matvec."""
    fs = list(factors)
    fs[mode] = None
    with obs.span("als/rhs", device=True, mode=mode):
        b = mttkrp_ctx(st, fs, mode, ctx, block_rows, path=mttkrp_path)
    mv = functools.partial(gram_matvec, omega, factors, mode, lam=lam,
                           ctx=ctx, h_slices=h_slices,
                           matvec_path=matvec_path, block_rows=block_rows,
                           mttkrp_path=mttkrp_path)
    with obs.span("als/cg", device=True, mode=mode):
        x, _ = batched_cg(mv, b, factors[mode], tol=cg_tol,
                          max_iters=cg_iters, ctx=ctx)
    return x


def als_sweep(st: SparseTensor, omega: SparseTensor,
              factors: Sequence[torch.Tensor], lam: float,
              cg_tol: float = 1e-4, cg_iters: int = 32,
              ctx: AxisCtx = LOCAL, h_slices: int = 1,
              matvec_path: str = "fused",
              block_rows: int = 8,
              mttkrp_path: Optional[str] = None) -> List[torch.Tensor]:
    """Full ALS sweep (all modes, in order). ``mttkrp_path`` opts the
    MTTKRP contractions into planner dispatch, as in the reference."""
    fs = list(factors)
    for d in range(st.ndim):
        fs[d] = als_update_mode(st, omega, fs, d, lam, cg_tol, cg_iters,
                                ctx, h_slices, matvec_path, block_rows,
                                mttkrp_path)
    return fs


# ---------------------------------------------------------------------------
# Explicit baseline: form all G^(i), solve with batched direct solves.
# O(mR²) work, O(IR²) memory — the bottleneck the implicit method removes.
# ---------------------------------------------------------------------------

def als_update_mode_explicit(st: SparseTensor, factors: List[torch.Tensor],
                             mode: int, lam: float,
                             ctx: AxisCtx = LOCAL) -> torch.Tensor:
    kr = None
    for d in range(st.ndim):
        if d == mode:
            continue
        rows = factors[d][st.indices[:, d]]
        kr = rows if kr is None else kr * rows                  # (cap, R)
    kr = kr * st.mask[:, None]
    rows = st.indices[:, mode].long()
    n_rows, r = st.shape[mode], kr.shape[1]
    outer = kr[:, :, None] * kr[:, None, :]
    gram = torch.zeros(n_rows, r, r, dtype=kr.dtype, device=kr.device)
    gram = ctx.psum_data(gram.index_add_(0, rows, outer))
    b = torch.zeros(n_rows, r, dtype=kr.dtype, device=kr.device)
    b = ctx.psum_data(b.index_add_(0, rows,
                                   (st.values * st.mask)[:, None] * kr))
    gram = gram + lam * torch.eye(r, dtype=gram.dtype, device=gram.device)
    return torch.linalg.solve(gram, b)


def als_sweep_explicit(st: SparseTensor, factors: Sequence[torch.Tensor],
                       lam: float, ctx: AxisCtx = LOCAL) -> List[torch.Tensor]:
    fs = list(factors)
    for d in range(st.ndim):
        fs[d] = als_update_mode_explicit(st, fs, d, lam, ctx)
    return fs
