"""Top-k retrieval, plainly: every item's score s_j = Σ_r Π_{d fixed}
A_d[i_d, r] · A_t[j, r] for each query, all of them formed, and the k
best."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tcbench.reference import common as C

CHECKS = ("rank_gap", "score_gap")
# what a returned list that is not k distinct items reads
BROKEN = 1e9


def scores(fixed: Dict[int, np.ndarray], factors: Sequence[torch.Tensor],
           target: int, prec: C.Precision) -> torch.Tensor:
    """(B, J) scores of every item of mode ``target``."""
    dev = factors[0].device
    q = None
    for d, v in sorted(fixed.items()):
        rows = prec(factors[d])[torch.as_tensor(v, device=dev).long()]
        q = rows if q is None else q * rows
    return q @ prec(factors[target]).T


def top(fixed, factors, target: int, k: int,
        prec: C.Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices), each (B, k), values descending."""
    s = scores(fixed, factors, target, prec)
    v, i = torch.topk(s, k, dim=1)
    return prec(v), i


def gaps(got: Tuple[np.ndarray, np.ndarray], ref: torch.Tensor,
         k: int) -> Tuple[float, float]:
    """For one call, against its float64 scores ``ref`` (B, J): how far
    the worst returned item's true score lies below the true k-th best,
    and the widest error of a returned score, both over the query's true
    best score."""
    vals, idx = got
    dev = ref.device
    idx_t = torch.as_tensor(np.asarray(idx), device=dev).long()
    j = ref.shape[1]
    if idx_t.min() < 0 or idx_t.max() >= j:
        return BROKEN, BROKEN
    if (torch.sort(idx_t, dim=1).values.diff(dim=1) == 0).any():
        return BROKEN, BROKEN
    best = torch.topk(ref, k, dim=1).values
    scale = torch.clamp(best[:, 0].abs(), min=1e-30)
    at = torch.gather(ref, 1, idx_t)
    rank = torch.clamp(best[:, -1:] - at, min=0.0) / scale[:, None]
    err = (torch.as_tensor(np.asarray(vals), device=dev).double() - at
           ).abs() / scale[:, None]
    return float(rank.max()), float(err.max())


def numbers(pairs: List[Tuple[float, float]]) -> Dict[str, float]:
    return {"rank_gap": max(p[0] for p in pairs),
            "score_gap": max(p[1] for p in pairs)}
