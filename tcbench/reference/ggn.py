"""Generalized Gauss-Newton tensor completion (damped Levenberg-Marquardt),
plainly, one iteration as the program states it:

1. joint step: flexible PCG for ``joint_iters`` steps on H Δ = −∇, with
   H = Jᵀ diag(ω) J + (2λ + μ) I, ω = max(ℓ''(t, m), 0); its matvec sums N
   TTTPs into z and runs N MTTKRPs on it; the preconditioner is
   block-Jacobi, ``precond_iters`` plain CG steps on each H_dd from zero;
   a line search over the fixed grid ``line_search`` (no decrease: α = 0);
2. per-mode damped pass (Gauss-Seidel): (H_dd + (2λ+μ) I) Δ_d = −∇_d by
   batched CG from zero, preconditioned by H_dd's diagonal, ``cg_iters``
   steps, rows frozen at ``cg_tol``;
3. accept when the objective did not rise; μ halves after a full step
   (α ≥ 1), stays for α ≥ 0.4, triples below, and grows tenfold on a
   rejection, within [1e-9, 1e6].

Steps 1 and 3 are choices: the best point of the grid, and accept or
reject. Where the program's damping says that it chose otherwise than the
reference, and the reference cannot tell the program's choice from its own
(objectives within ``tie`` of the objective, the objective's own limit),
the reference takes the program's choice, as a served model's reference
takes its greedy tokens, and says so on standard error.

H_dd is formed explicitly per row (R × R); the joint matvec runs its N
TTTPs and N MTTKRPs over each mode's grid of Khatri-Rao rows.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from tcbench.reference import common as C

CHECKS = ("factor_gap", "row_gap", "objective_gap", "damping_gap")

# value, first and second derivative in the model value m of each loss
LOSSES = {
    "quadratic": (lambda t, m: torch.square(t - m),
                  lambda t, m: 2.0 * (m - t),
                  lambda t, m: torch.full_like(m, 2.0)),
    "poisson_log": (lambda t, m: torch.exp(m) - t * m,
                    lambda t, m: torch.exp(m) - t,
                    lambda t, m: torch.exp(m)),
}
DAMPING_MIN, DAMPING_MAX = 1e-9, 1e6
DAMPING_REJECT = 10.0


def _kind(alpha: float) -> int:
    """The schedule's class of a step: 2 full (α ≥ 1), 1 (α ≥ 0.4), 0."""
    return 2 if alpha >= 1.0 else (1 if alpha >= 0.4 else 0)


SCALE = {2: 0.5, 1: 1.0, 0: 3.0}


def _damping(mu: float, ok: bool, kind: int) -> float:
    m = mu * SCALE[kind] if ok else mu * DAMPING_REJECT
    return min(max(m, DAMPING_MIN), DAMPING_MAX)


def said(mu: float, damping: Optional[float]) -> Optional[Tuple[bool, int]]:
    """(accepted, step class) that the program's damping after an iteration
    says it took from μ, or None where it matches none."""
    if damping is None:
        return None
    for ok, kind in ((True, 2), (True, 1), (True, 0), (False, None)):
        m = _damping(mu, ok, kind)
        if abs(m - damping) <= 1e-3 * m:
            return ok, kind
    return None


def choose_step(grid, objs, f0: float, took: Optional[Tuple[bool, int]],
                tie: float) -> Tuple[float, Optional[Dict]]:
    """The line search's step: the grid's best where it lowers f0, else 0;
    or the best step of the class the program took, where that lies
    within ``tie`` · |f0| of the best (a note says so)."""
    best = min(range(len(objs)), key=lambda i: (objs[i], i))
    alpha = grid[best] if objs[best] < f0 else 0.0
    if took is None or not took[0] or _kind(alpha) == took[1]:
        return alpha, None
    low = min(objs[best], f0)
    # the class's best, the first on the grid at equal objectives
    o, _, a = min((o, i, a) for i, (a, o) in
                  enumerate(list(zip(grid, objs)) + [(0.0, f0)])
                  if _kind(a) == took[1])
    gap = (o - low) / abs(f0)
    note = {"step": alpha, "program_class": took[1], "gap": gap}
    if gap <= tie:
        note["taken"] = a
        return a, note
    return alpha, note


def choose_accept(f_old: float, f_new: float,
                  took: Optional[Tuple[bool, int]],
                  tie: float) -> Tuple[bool, Optional[Dict]]:
    """Accept when the objective did not rise; or as the program did,
    where the two objectives lie within ``tie`` · |f_old|."""
    ok = f_new <= f_old
    if took is None or took[0] == ok:
        return ok, None
    gap = abs(f_new - f_old) / abs(f_old)
    note = {"accept": ok, "gap": gap}
    if gap <= tie:
        note["taken"] = took[0]
        return took[0], note
    return ok, note


def objective(p, fs, loss, lam: float, prec) -> torch.Tensor:
    m = C.tttp(p.idx, None, fs, prec)
    return loss[0](p.vals, m).sum() + lam * sum((f * f).sum() for f in fs)


def _curvature(p, fs, loss, prec):
    m = C.tttp(p.idx, None, fs, prec)
    return prec(torch.clamp(loss[2](p.vals, m), min=0.0)), m


def _tree_dot(a, b) -> torch.Tensor:
    return sum((x * y).sum() for x, y in zip(a, b))


def _block_cg_fixed(mv, b, iters: int, prec):
    x = torch.zeros_like(b)
    r, q = b, b
    rs = C.rowdot(b, b)
    for _ in range(iters):
        ap = mv(q)
        pap = C.rowdot(q, ap)
        alpha = rs / torch.where(pap > 0, pap, 1.0)
        x = prec(x + alpha[:, None] * q)
        r = prec(r - alpha[:, None] * ap)
        rs_new = C.rowdot(r, r)
        beta = rs_new / torch.where(rs > 0, rs, 1.0)
        q = prec(r + beta[:, None] * q)
        rs = rs_new
    return x


def _joint_step(p, fs, loss, s, mu, prec):
    lam, nd = s["lam"], len(fs)
    w, m = _curvature(p, fs, loss, prec)
    gv = prec(loss[1](p.vals, m))
    ks = [C.kr_grid(p, fs, d) for d in range(nd)]
    grads = [prec(C.mttkrp(p, gv, ks[d], d, prec) + 2.0 * lam * fs[d])
             for d in range(nd)]
    shift = 2.0 * lam + mu
    grams = [C.gram(p, w, ks[d], d) for d in range(nd)]

    def joint_mv(xs):
        # z_n = ω_n Σ_e ⟨k_n^(e), X_e[i_e]⟩, then one MTTKRP a mode on z
        z = None
        for e in range(nd):
            ke = torch.bmm(ks[e], xs[e][:, :, None])[:, :, 0]
            part = prec(w * p.rows(e).coo(ke))
            z = part if z is None else prec(z + part)
        return tuple(prec(C.mttkrp(p, z, ks[d], d, prec) + shift * xs[d])
                     for d in range(nd))

    def precond(rs):
        return tuple(_block_cg_fixed(
            lambda v, g=grams[d]: C.gram_apply(g, v, shift, prec), rs[d],
            s["precond_iters"], prec) for d in range(nd))

    b = tuple(-g for g in grads)
    x = tuple(torch.zeros_like(v) for v in b)
    r = b
    z = precond(r)
    q = z
    rz = _tree_dot(r, z)
    for _ in range(s["joint_iters"]):
        ap = joint_mv(q)
        alpha = rz / torch.clamp(_tree_dot(q, ap), min=1e-30)
        x = tuple(prec(xx + alpha * qq) for xx, qq in zip(x, q))
        r_new = tuple(prec(rr - alpha * aa) for rr, aa in zip(r, ap))
        z = precond(r_new)
        rz_new = _tree_dot(r_new, z)
        beta = (rz_new - _tree_dot(r, z)) / torch.clamp(rz, min=1e-30)
        q = tuple(prec(zz + beta * qq) for zz, qq in zip(z, q))
        r, rz = r_new, rz_new
    del ks, grams
    f0 = float(objective(p, fs, loss, lam, prec))
    objs = [float(objective(p, [prec(f + a * dd) for f, dd in zip(fs, x)],
                            loss, lam, prec)) for a in s["line_search"]]
    return x, f0, objs


def _mode_update(p, fs, d, loss, s, mu, prec):
    lam = s["lam"]
    w, m = _curvature(p, fs, loss, prec)
    gv = prec(loss[1](p.vals, m))
    k = C.kr_grid(p, fs, d)
    g = prec(C.mttkrp(p, gv, k, d, prec) + 2.0 * lam * fs[d])
    shift = 2.0 * lam + mu
    gr = C.gram(p, w, k, d)
    del k
    diag = prec(torch.diagonal(gr, dim1=1, dim2=2) + shift)
    delta = C.batched_pcg(lambda v: C.gram_apply(gr, v, shift, prec), -g,
                          torch.zeros_like(g), lambda v: v / diag,
                          s["cg_tol"], s["cg_iters"], prec)
    return prec(fs[d] + delta)


def iteration(p, fs, mu: float, loss, s, prec,
              took: Optional[Tuple[bool, int]] = None):
    """One iteration from ``fs`` at damping ``mu``; ``took`` is what the
    program's damping says it chose. Returns the factors, the damping and
    the notes of the choices taken from the program."""
    old = list(fs)
    x, f0, objs = _joint_step(p, list(fs), loss, s, mu, prec)
    alpha, step_note = choose_step(s["line_search"], objs, f0, took,
                                   s["tie"])
    fs = [prec(f + alpha * dd) for f, dd in zip(fs, x)]
    for d in range(len(fs)):
        fs[d] = _mode_update(p, fs, d, loss, s, mu, prec)
    f_old = float(objective(p, old, loss, s["lam"], prec))
    f_new = float(objective(p, fs, loss, s["lam"], prec))
    ok, accept_note = choose_accept(f_old, f_new, took, s["tie"])
    notes = [n for n in (step_note, accept_note) if n is not None]
    return (fs if ok else old), _damping(mu, ok, _kind(alpha)), notes


def follow(p, s: Dict, sweeps: int, prec: C.Precision,
           program: Optional[List[Dict]] = None) -> List[Dict]:
    """The factors, objective and damping after each of ``sweeps``
    iterations from the problem's initial factors; with ``program``, the
    answers judged, taking the program's choices where they tie."""
    loss = LOSSES[s["loss"]]
    fs = C.to_reference(p.factors, prec)
    mu = float(s["damping"])
    out = []
    for i in range(sweeps):
        took = said(mu, program[i].get("damping")) if program else None
        fs, mu, notes = iteration(p, fs, mu, loss, s, prec, took)
        for n in notes:
            print(f"tcbench: reference, GGN iteration {i + 1}: the program "
                  f"chose otherwise: {n}", file=sys.stderr, flush=True)
        out.append({"factors": [f.cpu() for f in fs],
                    "objective": float(objective(p, fs, loss, s["lam"],
                                                 prec)),
                    "damping": mu, "notes": notes})
    return out


def numbers(got: List[Dict], want: List[Dict],
            p: C.Problem) -> Dict[str, float]:
    """Worst over the compared iterations: the factors' relative gap, the
    worst factor row's, the objective's and the damping's."""
    return {
        "factor_gap": max(C.factor_gap(g["factors"], w["factors"])
                          for g, w in zip(got, want)),
        "row_gap": max(C.row_gap(g["factors"], w["factors"])
                       for g, w in zip(got, want)),
        "objective_gap": max(abs(g["objective"] - w["objective"])
                             / abs(w["objective"]) for g, w in zip(got, want)),
        "damping_gap": max(abs(g["damping"] - w["damping"]) / w["damping"]
                           for g, w in zip(got, want)),
    }
