"""CCD++ for tensor completion (paper §2.3, Listings 5–6).

Keeps the sparse residual ρ_n = t_n − ⟨u_i, v_j, w_k⟩ on the Ω pattern and
updates one factor column at a time, alternating modes per column (CCD++
ordering). Closed-form column update:

    u_ir ← ( Σ_{(j,k)∈Ω_i} v_jr w_kr ρ^(r)_n ) / ( λ + Σ_{(j,k)∈Ω_i} v²_jr w²_kr )
    with ρ^(r)_n = ρ_n + u_ir v_jr w_kr  (the old rank-1 term added back)

Two implementations, as in the paper:

* ``ccd_sweep`` — gather, product and ``index_add_`` segment sums
  (Listing 5), plain PyTorch as the reference's is plain ``jnp``;
* ``ccd_sweep_tttp`` — through the planner's TTTP (the TTTP kernel on
  vector factors, R = 1) and the planner's sparse mode reduction (Listing
  6): two TTTP launches per column update.

The reference's loop over columns (``fori_loop``) is a Python loop here.
Each sweep clones the factors once and writes the new columns into the
clones, so the caller's factors are left as they were.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import (LOCAL, AxisCtx, reduce_mode_ctx,
                                          tttp_ctx)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values


def residual_values(st: SparseTensor, factors: Sequence[torch.Tensor],
                    ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """ρ_n = t_n − model_n on the Ω pattern (model values by TTTP)."""
    model = ctx.psum_model(multilinear_values(st, list(factors)))
    return (st.values - model) * st.mask


def _segment_sum(vals: torch.Tensor, rows: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, rows, vals)


def _ccd_column_update_einsum(rho, st, cols, mode, lam, ctx):
    """Numerator and denominator by gather → product → segment sum."""
    vw = torch.ones_like(rho)
    vw2 = torch.ones_like(rho)
    for d in range(st.ndim):
        if d == mode:
            continue
        c = cols[d][st.indices[:, d]]
        vw = vw * c
        vw2 = vw2 * torch.square(c)
    rows = st.indices[:, mode].long()
    n = st.shape[mode]
    a = ctx.psum_data(_segment_sum(vw * rho, rows, n))
    den0 = ctx.psum_data(_segment_sum(vw2 * st.mask, rows, n))
    new_col = (a + cols[mode] * den0) / (lam + den0)
    # residual update: ρ += (old − new) v w at each nonzero
    delta = (cols[mode] - new_col)[rows] * vw
    return new_col, (rho + delta) * st.mask


def _ccd_column_update_tttp(rho, st, cols, mode, lam, ctx, path=None):
    """The same update through TTTP and the sparse mode reduction (Listing
    6). Two TTTP launches per column update: vw = TTTP(Ω, [None, v, w])
    serves both the numerator (ρ·vw ≡ TTTP(ρ, [None, v, w]) on the shared
    Ω pattern) and the residual update; the second is TTTP(Ω, [None, v², w²])
    for the denominator."""
    fac = [None] * st.ndim
    fac2 = [None] * st.ndim
    for d in range(st.ndim):
        if d != mode:
            fac[d] = cols[d]
            fac2[d] = torch.square(cols[d])
    omega = st.with_values(torch.ones_like(rho) * st.mask)
    vw_sp = tttp_ctx(omega, fac, ctx, path=path)
    vw = vw_sp.values
    a = reduce_mode_ctx(vw_sp.with_values(rho * vw), mode, ctx)
    den0 = reduce_mode_ctx(tttp_ctx(omega, fac2, ctx, path=path), mode, ctx)
    new_col = (a + cols[mode] * den0) / (lam + den0)
    rows = st.indices[:, mode].long()
    delta = (cols[mode] - new_col)[rows] * vw
    return new_col, (rho + delta) * st.mask


def _ccd_sweep_impl(update_fn, st, factors, rho, lam, ctx):
    fs = [f.clone() for f in factors]
    for r in range(fs[0].shape[1]):
        for d in range(st.ndim):
            # contiguous columns: the TTTP kernel takes contiguous factors
            cols = [f[:, r].contiguous() for f in fs]
            new_col, rho = update_fn(rho, st, cols, d, lam, ctx)
            fs[d][:, r] = new_col
    return fs, rho


def ccd_sweep(st: SparseTensor, factors: Sequence[torch.Tensor],
              rho: torch.Tensor, lam: float, ctx: AxisCtx = LOCAL
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One CCD++ sweep (every column × every mode), gather/segment-sum
    variant."""
    return _ccd_sweep_impl(_ccd_column_update_einsum, st, factors, rho, lam,
                           ctx)


def ccd_sweep_tttp(st: SparseTensor, factors: Sequence[torch.Tensor],
                   rho: torch.Tensor, lam: float, ctx: AxisCtx = LOCAL,
                   tttp_path: Optional[str] = None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One CCD++ sweep, TTTP variant (paper Listing 6). ``tttp_path`` forces
    the TTTP contractions onto a planner candidate."""
    update = functools.partial(_ccd_column_update_tttp, path=tttp_path)
    return _ccd_sweep_impl(update, st, factors, rho, lam, ctx)
