"""Generalized Gauss-Newton (damped Levenberg–Marquardt) tensor completion,
matrix-free on the eq.-3 Gram matvec.

Minimizes  Σ_{n∈Ω} ℓ(t_n, m_n) + λ Σ_d ‖A_d‖²_F  for any elementwise loss
with first and second derivatives (``repro_torch.core.losses``). With J the
Jacobian of the model values (J_d's rows are the Khatri-Rao rows
Π_{e≠d} A_e[i_e, :]) the generalized Gauss-Newton Hessian is

    H = Jᵀ diag(ω) J + (2λ + μ) I,    ω_n = max(ℓ''(t_n, m_n), 0)

with μ the Levenberg–Marquardt damping. Its diagonal blocks H_dd are the
paper's eq.-3 Gram matvec with the curvature ω as weights. One iteration
(:func:`ggn_sweep`) is:

1. **Joint LM step**: flexible CG on H Δ = −∇, whose matvec sums the N TTTP
   halves into one z and runs N MTTKRPs on it, preconditioned block-Jacobi
   by a fixed number of batched-CG iterations on each H_dd; a static line
   search over ``LINE_SEARCH_ALPHAS`` picks the step length.
2. **Per-mode damped pass** (Gauss-Seidel): (H_dd + (2λ+μ)I) Δ_d = −∇_d by
   batched CG with the diagonal of H_dd as preconditioner. For quadratic
   loss (ω ≡ 2, μ = 0) this is the ALS implicit-CG update.
3. **Accept/reject**: an iteration that raises the objective is rolled
   back and μ raised; full steps lower μ.

Every H_dd matvec is :func:`als.gram_matvec` on the curvature tensor
``w_st``: on the card the fused CG-matvec kernel with weights ω (or TTTP +
MTTKRP, or a planner candidate, by ``matvec_path``), over ``w_st``'s bucket
view, which ``row_buckets`` gathers once per mode and tensor. As in the reference there
is no host synchronisation: the damping and the step α stay 0-d device
tensors, the line search takes ``argmin`` on the device, accept/reject is
``torch.where`` and every solver runs a fixed trip count.

While tracing is live an iteration's phases run in device-timed ``obs``
spans: ``ggn/curvature`` (ω and the model values), ``ggn/gradient``,
``ggn/pcg`` (the joint flexible PCG with its block-Jacobi
preconditioner), ``ggn/line_search``, ``ggn/mode_cg`` (a mode's damped
pass: its diagonal preconditioner and batched CG; attr ``mode``) and
``ggn/accept``.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.completion.als import batched_pcg, gram_matvec
from repro_torch.core.completion.gcp import gcp_loss
from repro_torch.core.distributed import LOCAL, AxisCtx, mttkrp_ctx, rowdot_ctx
from repro_torch.core.losses import Loss
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values
from repro_torch.kernels import ops as kops

# Levenberg–Marquardt damping schedule: decrease on a full accepted step,
# increase on rejection or a heavily truncated line search
DAMPING_MIN = 1e-9
DAMPING_MAX = 1e6
DAMPING_DECREASE = 0.5
DAMPING_INCREASE = 10.0
DAMPING_TRUNCATED = 3.0

# static line-search grid for the joint step (0 ⇒ reject the step)
LINE_SEARCH_ALPHAS = (2.0, 1.5, 1.25, 1.0, 0.8, 0.65, 0.5, 0.4, 0.3,
                      0.2, 0.1)


class GGNState(NamedTuple):
    """Solver state threaded through iterations."""
    factors: Tuple[torch.Tensor, ...]
    damping: torch.Tensor   # () — current LM μ, on the factors' device


def ggn_init(factors: Sequence[torch.Tensor],
             damping: float = 1e-5) -> GGNState:
    return GGNState(tuple(factors),
                    torch.full((), damping, dtype=factors[0].dtype,
                               device=factors[0].device))


# ---------------------------------------------------------------------------
# solvers (batched_pcg, the masked-convergence PCG, lives in als.py)
# ---------------------------------------------------------------------------

def _block_cg_fixed(matvec: Callable, b: torch.Tensor, iters: int,
                    ctx: AxisCtx) -> torch.Tensor:
    """Fixed-iteration batched CG from zero: the block-Jacobi apply of the
    joint solve (a fixed operator, as a preconditioner must be)."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = rowdot_ctx(b, b, ctx)
    for _ in range(iters):
        ap = matvec(p)
        pap = rowdot_ctx(p, ap, ctx)
        alpha = rs / torch.where(pap > 0, pap, 1.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = rowdot_ctx(r, r, ctx)
        beta = rs_new / torch.where(rs > 0, rs, 1.0)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def _tree_dot(a, b, ctx: AxisCtx) -> torch.Tensor:
    return ctx.psum_model(sum(torch.sum(x * y) for x, y in zip(a, b)))


def _flexible_pcg(matvec: Callable, b, precond: Callable, iters: int,
                  ctx: AxisCtx):
    """Flexible (Polak–Ribière) PCG over a tuple-of-factors unknown; the
    preconditioner may itself be an inexact iterative solve."""
    x = tuple(torch.zeros_like(v) for v in b)
    r = tuple(b)
    z = precond(r)
    p = tuple(z)
    rz = _tree_dot(r, z, ctx)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rz / torch.clamp(_tree_dot(p, ap, ctx), min=1e-30)
        x = tuple(xx + alpha * pp for xx, pp in zip(x, p))
        r_new = tuple(rr - alpha * aa for rr, aa in zip(r, ap))
        z = precond(r_new)
        rz_new = _tree_dot(r_new, z, ctx)
        # flexible beta: (rz_new − ⟨r_old, z_new⟩) / rz_old
        beta = (rz_new - _tree_dot(r, z, ctx)) / torch.clamp(rz, min=1e-30)
        p = tuple(zz + beta * pp for zz, pp in zip(z, p))
        r, rz = r_new, rz_new
    return x


# ---------------------------------------------------------------------------
# GGN pieces
# ---------------------------------------------------------------------------

def curvature_tensor(st: SparseTensor, factors: Sequence[torch.Tensor],
                     loss: Loss, ctx: AxisCtx = LOCAL
                     ) -> Tuple[SparseTensor, torch.Tensor]:
    """(ω-valued tensor, model values): ω_n = max(ℓ''(t_n, m_n), 0) on Ω.

    The clip keeps the GGN system PSD where the clamped curvature vanishes
    (poisson below the floor, huber outside δ). The ω tensor shares ``st``'s
    bucket patterns."""
    with obs.span("ggn/curvature", device=True):
        model = ctx.psum_model(multilinear_values(st, list(factors)))
        w = torch.where(st.mask, loss.hess(st.values, model), 0.0)
        return st.with_values(torch.clamp(w, min=0.0)), model


def _gradients(st: SparseTensor, factors: List[torch.Tensor],
               model: torch.Tensor, loss: Loss, lam: float, ctx: AxisCtx,
               mttkrp_path: Optional[str],
               block_rows: int) -> List[torch.Tensor]:
    with obs.span("ggn/gradient", device=True):
        g_st = st.with_values(torch.where(st.mask,
                                          loss.grad(st.values, model), 0.0))
        grads = []
        for d in range(st.ndim):
            fs = list(factors)
            fs[d] = None
            grads.append(mttkrp_ctx(g_st, fs, d, ctx, block_rows,
                                    path=mttkrp_path)
                         + 2.0 * lam * factors[d])
        return grads


def joint_ggn_matvec(st: SparseTensor, w_st: SparseTensor,
                     factors: List[torch.Tensor], xs: Sequence[torch.Tensor],
                     shift, ctx: AxisCtx = LOCAL,
                     mttkrp_path: Optional[str] = None,
                     block_rows: int = 8) -> Tuple[torch.Tensor, ...]:
    """(H X)_d for the joint system: z_n = ω_n Σ_e ⟨KR-row, X_e⟩ from N TTTP
    calls (each with ``X_e`` in place of factor e, on the ω values, so the
    products come out weighted), then one bucketed MTTKRP per mode on z.
    Θ(N·mR) work, covering all N² blocks. z is a new tensor on every call,
    so each MTTKRP gathers it through its mode's bucket pattern."""
    zv = None
    for e in range(st.ndim):
        fs = list(factors)
        fs[e] = xs[e]
        part = kops.tttp_values(w_st, fs)
        zv = part if zv is None else zv + part
    z = w_st.with_values(ctx.psum_model(zv))
    out = []
    for d in range(st.ndim):
        fs = [None if e == d else factors[e] for e in range(st.ndim)]
        out.append(mttkrp_ctx(z, fs, d, ctx, block_rows, path=mttkrp_path)
                   + shift * xs[d])
    return tuple(out)


def ggn_update_mode(st: SparseTensor, factors: List[torch.Tensor], mode: int,
                    loss: Loss, lam: float, damping,
                    cg_tol: float = 1e-4, cg_iters: int = 32,
                    ctx: AxisCtx = LOCAL, h_slices: int = 1,
                    matvec_path: str = "fused",
                    mttkrp_path: Optional[str] = None,
                    block_rows: int = 8) -> torch.Tensor:
    """One damped per-mode GGN update: solve (H_dd + (2λ+μ)I) Δ = −∇_d by
    diagonal-preconditioned batched CG, return A_d + Δ."""
    w_st, model = curvature_tensor(st, factors, loss, ctx)
    with obs.span("ggn/gradient", device=True, mode=mode):
        g_st = st.with_values(torch.where(st.mask,
                                          loss.grad(st.values, model), 0.0))
        fs_g = list(factors)
        fs_g[mode] = None
        g = mttkrp_ctx(g_st, fs_g, mode, ctx, block_rows,
                       path=mttkrp_path) + 2.0 * lam * factors[mode]
    shift = 2.0 * lam + damping
    mv = functools.partial(gram_matvec, w_st, list(factors), mode,
                           lam=shift, ctx=ctx, h_slices=h_slices,
                           matvec_path=matvec_path, block_rows=block_rows,
                           mttkrp_path=mttkrp_path)
    # diagonal of each row's R×R block, one MTTKRP on squared factors:
    # diag_i[r] = Σ_{n∈Ω_i} ω_n Π_{e≠d} A_e[i_e, r]²
    with obs.span("ggn/mode_cg", device=True, mode=mode):
        sq = [None if d == mode else torch.square(f)
              for d, f in enumerate(factors)]
        diag = mttkrp_ctx(w_st, sq, mode, ctx, block_rows,
                          path=mttkrp_path) + shift
        delta, _ = batched_pcg(mv, -g, torch.zeros_like(g),
                               precond=lambda v: v / diag,
                               tol=cg_tol, max_iters=cg_iters, ctx=ctx)
        return factors[mode] + delta


def joint_ggn_step(st: SparseTensor, factors: List[torch.Tensor], loss: Loss,
                   lam: float, damping, joint_iters: int = 15,
                   precond_iters: int = 8, ctx: AxisCtx = LOCAL,
                   h_slices: int = 1, matvec_path: str = "fused",
                   mttkrp_path: Optional[str] = None, block_rows: int = 8
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One joint LM step with line search. Returns (new factors, step α);
    α = 0 means the step was rejected (no objective decrease)."""
    w_st, model = curvature_tensor(st, factors, loss, ctx)
    g = _gradients(st, factors, model, loss, lam, ctx, mttkrp_path,
                   block_rows)
    shift = 2.0 * lam + damping
    mv = functools.partial(joint_ggn_matvec, st, w_st, list(factors),
                           shift=shift, ctx=ctx, mttkrp_path=mttkrp_path,
                           block_rows=block_rows)

    def precond(rs):
        # block-Jacobi: each H_dd⁻¹ applied by a fixed number of batched-CG
        # iterations on the eq.-3 weighted Gram matvec
        out = []
        for d in range(st.ndim):
            mvd = functools.partial(gram_matvec, w_st, list(factors), d,
                                    lam=shift, ctx=ctx, h_slices=h_slices,
                                    matvec_path=matvec_path,
                                    block_rows=block_rows,
                                    mttkrp_path=mttkrp_path)
            out.append(_block_cg_fixed(mvd, rs[d], precond_iters, ctx))
        return tuple(out)

    with obs.span("ggn/pcg", device=True):
        delta = _flexible_pcg(mv, tuple(-gg for gg in g), precond,
                              joint_iters, ctx)
    with obs.span("ggn/line_search", device=True):
        f0 = gcp_loss(st, list(factors), loss, lam, ctx)
        objs = torch.stack([gcp_loss(st, [f + a * d_ for f, d_ in
                                          zip(factors, delta)], loss, lam,
                                     ctx)
                            for a in LINE_SEARCH_ALPHAS])
        best = torch.argmin(objs)
        # the grid as a device tensor, built by fills (no host-to-device
        # copy)
        alphas = torch.stack([torch.full((), a, dtype=f0.dtype,
                                         device=f0.device)
                              for a in LINE_SEARCH_ALPHAS])
        alpha = torch.where(objs[best] < f0, alphas[best], 0.0)
        new = [f + alpha * d_ for f, d_ in zip(factors, delta)]
        return new, alpha


def ggn_sweep(st: SparseTensor, state: GGNState, loss: Loss, lam: float,
              cg_tol: float = 1e-4, cg_iters: int = 32,
              joint_iters: int = 15, precond_iters: int = 8,
              use_joint: bool = True, ctx: AxisCtx = LOCAL,
              h_slices: int = 1, matvec_path: str = "fused",
              mttkrp_path: Optional[str] = None,
              adapt_damping: bool = True, block_rows: int = 8) -> GGNState:
    """One GGN iteration: joint LM step (optional), then a per-mode damped
    pass (Gauss-Seidel), then LM accept/reject of the whole iteration."""
    fs = list(state.factors)
    mu = state.damping
    if use_joint:
        fs, alpha = joint_ggn_step(st, fs, loss, lam, mu,
                                   joint_iters=joint_iters,
                                   precond_iters=precond_iters, ctx=ctx,
                                   h_slices=h_slices,
                                   matvec_path=matvec_path,
                                   mttkrp_path=mttkrp_path,
                                   block_rows=block_rows)
    else:
        alpha = torch.ones((), dtype=fs[0].dtype, device=fs[0].device)
    for d in range(st.ndim):
        fs[d] = ggn_update_mode(st, fs, d, loss, lam, mu, cg_tol, cg_iters,
                                ctx, h_slices, matvec_path=matvec_path,
                                mttkrp_path=mttkrp_path,
                                block_rows=block_rows)
    if not adapt_damping:
        return GGNState(tuple(fs), mu)
    with obs.span("ggn/accept", device=True):
        f_old = gcp_loss(st, list(state.factors), loss, lam, ctx)
        f_new = gcp_loss(st, fs, loss, lam, ctx)
        ok = f_new <= f_old
        factors = tuple(torch.where(ok, new, old)
                        for new, old in zip(fs, state.factors))
        # μ schedule: shrink on a full step, grow when the line search had
        # to truncate hard (the GN direction overshot), grow harder on
        # rejection
        mu_acc = torch.where(alpha >= 1.0, mu * DAMPING_DECREASE,
                             torch.where(alpha >= 0.4, mu,
                                         mu * DAMPING_TRUNCATED))
        mu = torch.clamp(torch.where(ok, mu_acc, mu * DAMPING_INCREASE),
                         DAMPING_MIN, DAMPING_MAX)
        return GGNState(factors, mu)
