"""ALS for tensor completion with implicit batched conjugate gradient (paper
§2.2), plus the explicit Gram-forming baseline it improves upon.

For each mode, solve the I independent R×R SPD systems
    (G^(i) + λI) u_i = b_i,   b = MTTKRP(T, factors)
without forming G^(i). The batched matvec (paper eq. 3) is

    Y = MTTKRP( TTTP(Ω, [..., X at mode, ...]), factors ) + λX

run either as one fused pass over the Ω buckets (``matvec_path="fused"``,
the fused CG-matvec kernel) or as the TTTP kernel followed by the bucketed
MTTKRP kernel (``"tttp_mttkrp"``).

CG runs a fixed ``max_iters`` iterations with no host synchronisation.
The reference stops as soon as every row has converged; here converged rows
are frozen by the same masks (``alpha = beta = 0`` leaves x and r exactly
unchanged) and the loop goes on, so the factors are the same. The count of
iterations in which some row was still active stays on the device.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from repro_torch.core.distributed import (LOCAL, AxisCtx, mttkrp_ctx,
                                          rowdot_ctx, tttp_ctx)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops as kops

MATVEC_PATHS = ("fused", "tttp_mttkrp")


def gram_matvec(omega: SparseTensor, factors: Sequence[torch.Tensor],
                mode: int, x: torch.Tensor, lam: float,
                ctx: AxisCtx = LOCAL, h_slices: int = 1,
                matvec_path: str = "fused",
                block_rows: int = 8) -> torch.Tensor:
    """(G_ω + λI) x via the implicit eq.-3 matvec. ``omega.values`` are the
    per-entry weights ω_n (the Ω indicator for plain ALS)."""
    if h_slices != 1:
        raise NotImplementedError("H-sliced matvec is not ported yet")
    if matvec_path == "fused":
        buckets = omega.row_buckets(mode, block_rows)
        y = kops.cg_matvec_bucketed(buckets, factors, x,
                                    num_rows=omega.shape[mode])
        return ctx.psum_data(y) + lam * x
    if matvec_path == "tttp_mttkrp":
        fs = list(factors)
        fs[mode] = x
        z = tttp_ctx(omega, fs, ctx)     # z_n = ω_n Σ_s Π a_ds · x_is
        fs[mode] = None
        return mttkrp_ctx(z, fs, mode, ctx, block_rows) + lam * x
    raise ValueError(f"matvec_path {matvec_path!r} not in {MATVEC_PATHS}")


def batched_pcg(matvec, b: torch.Tensor, x0: torch.Tensor, precond=None,
                tol: float = 1e-4, max_iters: int = 32,
                ctx: AxisCtx = LOCAL):
    """Preconditioned batched-rows CG on SPD systems; rows converge
    independently and converged rows (residual² ≤ tol²·‖b_row‖²) are frozen
    by masking. Runs ``max_iters`` iterations (see the module docstring).
    Returns ``(x, iters)`` with ``iters`` a device tensor: the iterations in
    which some row was active, the reference's trip count."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    bnorm2 = rowdot_ctx(b, b, ctx)
    thresh = (tol ** 2) * torch.clamp(bnorm2, min=1e-30)
    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = rowdot_ctx(r, z, ctx)
    rs = rowdot_ctx(r, r, ctx)
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(max_iters):
        active = rs > thresh
        iters += active.any()
        ap = matvec(p)
        pap = rowdot_ctx(p, ap, ctx)
        alpha = torch.where(active, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = precond(r)
        rz_new = rowdot_ctx(r, z, ctx)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0),
                           0.0)
        p = z + beta[:, None] * p
        rz = rz_new
        rs = rowdot_ctx(r, r, ctx)
    return x, iters


def batched_cg(matvec, b: torch.Tensor, x0: torch.Tensor, tol: float = 1e-4,
               max_iters: int = 32, ctx: AxisCtx = LOCAL):
    """Unpreconditioned :func:`batched_pcg`."""
    return batched_pcg(matvec, b, x0, precond=None, tol=tol,
                       max_iters=max_iters, ctx=ctx)


def als_update_mode(st: SparseTensor, omega: SparseTensor,
                    factors: List[torch.Tensor], mode: int, lam: float,
                    cg_tol: float = 1e-4, cg_iters: int = 32,
                    ctx: AxisCtx = LOCAL, h_slices: int = 1,
                    matvec_path: str = "fused",
                    block_rows: int = 8) -> torch.Tensor:
    """One ALS factor update by implicit CG: b from the bucketed MTTKRP
    kernel, then ``cg_iters`` batched CG steps on the eq.-3 matvec."""
    fs = list(factors)
    fs[mode] = None
    b = mttkrp_ctx(st, fs, mode, ctx, block_rows)
    mv = functools.partial(gram_matvec, omega, factors, mode, lam=lam,
                           ctx=ctx, h_slices=h_slices,
                           matvec_path=matvec_path, block_rows=block_rows)
    x, _ = batched_cg(mv, b, factors[mode], tol=cg_tol, max_iters=cg_iters,
                      ctx=ctx)
    return x


def als_sweep(st: SparseTensor, omega: SparseTensor,
              factors: Sequence[torch.Tensor], lam: float,
              cg_tol: float = 1e-4, cg_iters: int = 32,
              ctx: AxisCtx = LOCAL, h_slices: int = 1,
              matvec_path: str = "fused",
              block_rows: int = 8) -> List[torch.Tensor]:
    """Full ALS sweep (all modes, in order)."""
    fs = list(factors)
    for d in range(st.ndim):
        fs[d] = als_update_mode(st, omega, fs, d, lam, cg_tol, cg_iters,
                                ctx, h_slices, matvec_path, block_rows)
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
