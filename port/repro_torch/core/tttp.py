"""TTTP — tensor-times-tensor-product (paper §3.2):

    x_{i1..iN} = s_{i1..iN} · Σ_r Π_j A^(j)[i_j, r]

with ``None`` allowed in the factor list (the product runs over the given
modes only) and vectors accepted as single-column matrices. Both functions
route to ``kernels.ops.tttp_values``: the TTTP kernel on the card, its plain
version on the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops as kops


def _normalize_factors(factors: Sequence[Optional[torch.Tensor]]):
    """Promote vectors to single-column matrices; return (list, R)."""
    out: List[Optional[torch.Tensor]] = []
    r = None
    for f in factors:
        if f is None:
            out.append(None)
            continue
        if f.dim() == 1:
            f = f[:, None]
        if r is None:
            r = f.shape[1]
        elif f.shape[1] != r:
            raise ValueError("TTTP factors must share the rank dimension")
        out.append(f)
    if r is None:
        raise ValueError("TTTP requires at least one factor")
    return out, r


def multilinear_values(st: SparseTensor,
                       factors: Sequence[Optional[torch.Tensor]]
                       ) -> torch.Tensor:
    """Σ_r Π_j A^(j)[idx_j, r] per valid nonzero (0 on padding slots)."""
    fs, _ = _normalize_factors(factors)
    return kops.tttp_values(st.with_values(torch.ones_like(st.values)), fs)


def tttp(st: SparseTensor,
         factors: Sequence[Optional[torch.Tensor]]) -> SparseTensor:
    """All-at-once TTTP."""
    fs, _ = _normalize_factors(factors)
    return kops.tttp(st, fs)
