"""TTTP — tensor-times-tensor-product (paper §3.2):

    x_{i1..iN} = s_{i1..iN} · Σ_r Π_j A^(j)[i_j, r]

with ``None`` allowed in the factor list (the product runs over the given
modes only) and vectors accepted as single-column matrices (R = 1).

* ``tttp`` and ``multilinear_values`` — all at once, routed to
  ``kernels.ops.tttp_values``: the TTTP kernel on the card, its plain
  version on the CPU;
* ``tttp_sliced`` — the paper's H-sliced schedule: R cut into H column
  slices, one TTTP call per slice, the partial sums added;
* ``tttp_pairwise`` — the pairwise-contraction baseline the paper compares
  against (Fig. 6): it materialises the (cap, R) intermediate, in plain
  PyTorch as the reference's is plain ``jnp``.
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


def tttp_sliced(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
                num_slices: int) -> SparseTensor:
    """H-sliced TTTP: the same output, the Khatri-Rao work cut into
    ``num_slices`` column slices of R/H (R must be divisible by H)."""
    fs, r = _normalize_factors(factors)
    if r % num_slices != 0:
        raise ValueError(f"R={r} not divisible by H={num_slices}")
    rs = r // num_slices
    acc = torch.zeros(st.cap, dtype=st.values.dtype, device=st.device)
    for h in range(num_slices):
        sl = [None if f is None else f[:, h * rs:(h + 1) * rs].contiguous()
              for f in fs]
        acc = acc + multilinear_values(st, sl)
    return st.with_values(st.values * acc)


def tttp_pairwise(st: SparseTensor,
                  factors: Sequence[Optional[torch.Tensor]]) -> SparseTensor:
    """Pairwise-contraction baseline (paper Fig. 6): forms the order-(N+1)
    intermediate x_{i..r} = s_{i..} a^(1)_{i1 r}, multiplies in one factor
    at a time (a (cap, R) tensor at each step), then sums over r."""
    fs, r = _normalize_factors(factors)
    inter = st.masked_values()[:, None].expand(st.cap, r)
    for d, f in enumerate(fs):
        if f is None:
            continue
        inter = inter * f[st.indices[:, d]]
    return st.with_values(inter.sum(dim=1))


def cp_residual_norm(st: SparseTensor, factors: Sequence[torch.Tensor],
                     lambda_reg: float = 0.0) -> torch.Tensor:
    """‖T − [[A_1, …, A_N]]‖ over the observed entries, via TTTP (paper
    §3.2 use case). ``lambda_reg`` is accepted and unused, as in the
    reference."""
    model = multilinear_values(st, factors)
    diff = (st.values - model) * st.mask
    return torch.sqrt(torch.sum(torch.square(diff)))
