"""Fold-in of cold users, plainly: each user's row solves the damped
one-row ALS system (G_u + λI) x_u = b_u over the user's history, with
G_u = Σ k_n k_nᵀ and b_u = Σ t_n k_n, k_n the Khatri-Rao row of the frozen
factors of the other modes, by a direct solve (the program runs CG to
convergence on the same system)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from tcbench.reference import common as C

CHECKS = ("row_gap",)


def solve(call, factors: Sequence[torch.Tensor], mode: int, lam: float,
          prec: C.Precision) -> torch.Tensor:
    """(users, R) rows of one call (``gen.FoldinCall``)."""
    dev = factors[0].device
    others = [d for d in range(len(factors)) if d != mode]
    users = len(call.offsets) - 1
    counts = torch.as_tensor(np.diff(call.offsets), device=dev)
    user = torch.repeat_interleave(torch.arange(users, device=dev), counts)
    idx = torch.as_tensor(call.indices, device=dev).long()
    k = None
    for c, d in enumerate(others):
        rows = prec(factors[d])[idx[:, c]]
        k = rows if k is None else k * rows
    r = k.shape[1]
    vals = prec(torch.as_tensor(call.values, device=dev))
    g = torch.zeros(users, r * r, dtype=prec.compute, device=dev)
    g.index_add_(0, user, (k[:, :, None] * k[:, None, :]).reshape(-1, r * r))
    b = torch.zeros(users, r, dtype=prec.compute, device=dev)
    b.index_add_(0, user, vals[:, None] * k)
    eye = torch.eye(r, dtype=prec.compute, device=dev)
    return prec(torch.linalg.solve(g.reshape(users, r, r) + lam * eye,
                                   b[:, :, None])[:, :, 0])


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst user's ‖x − x_ref‖ / max(‖x_ref‖, the call's median row
    norm)."""
    got, want = got.double().to(want.device), want.double()
    norms = torch.linalg.norm(want, dim=1)
    floor = torch.clamp(norms, min=float(norms.median()))
    return float((torch.linalg.norm(got - want, dim=1) / floor).max())


def numbers(got: List[torch.Tensor], want: List[torch.Tensor]
            ) -> Dict[str, float]:
    return {"row_gap": max(row_gap(g, w) for g, w in zip(got, want))}
