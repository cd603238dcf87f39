"""ALS for tensor completion with implicit CG (paper §2.2), plainly: for
each mode in turn, b = MTTKRP(T) and (G_i + λI) u_i = b_i by batched CG
from the current factor for ``cg_iters`` steps, rows frozen once their
residual meets ``cg_tol``. The Gram matrices G_i = Σ_{n∈Ω_i} k_n k_nᵀ are
formed explicitly (R × R a row), so the matvec is a batched product: the
same operator as the program's implicit eq.-3 matvec, reached another way.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from tcbench.reference import common as C

CHECKS = ("factor_gap", "row_gap", "rmse_gap")


def sweep(p: C.Problem, fs: List, s: Dict, prec: C.Precision) -> List:
    fs = list(fs)
    for d in range(len(fs)):
        k = C.kr_grid(p, fs, d)
        b = C.mttkrp(p, p.vals, k, d, prec)
        g = C.gram(p, None, k, d)
        del k
        fs[d] = C.batched_pcg(
            lambda x: C.gram_apply(g, x, s["lam"], prec), b, fs[d], None,
            s["cg_tol"], s["cg_iters"], prec)
    return fs


def follow(p: C.Problem, s: Dict, sweeps: int, prec: C.Precision,
           program: Optional[List[Dict]] = None) -> List[Dict]:
    """The factors and RMSE after each of ``sweeps`` sweeps from the
    problem's initial factors (an ALS sweep has no choice to follow, so
    ``program`` is not read)."""
    fs = C.to_reference(p.factors, prec)
    out = []
    for _ in range(sweeps):
        fs = sweep(p, fs, s, prec)
        out.append({"factors": [f.cpu() for f in fs],
                    "rmse": C.rmse(p, fs, prec)})
    return out


def numbers(got: List[Dict], want: List[Dict],
            p: C.Problem) -> Dict[str, float]:
    """Worst over the compared sweeps: the factors' relative gap, the
    worst factor row's, and the RMSE's."""
    return {
        "factor_gap": max(C.factor_gap(g["factors"], w["factors"])
                          for g, w in zip(got, want)),
        "row_gap": max(C.row_gap(g["factors"], w["factors"])
                       for g, w in zip(got, want)),
        "rmse_gap": max(abs(g["rmse"] - w["rmse"]) / abs(w["rmse"])
                        for g, w in zip(got, want)),
    }
