"""Plain PyTorch versions of the three CUDA kernels. The wrappers in
``kernels.ops`` run these for tensors on the CPU; the card's smoke test
holds each kernel against them on the same inputs.

Each takes ``acc_dtype``, the accumulator of a ``KernelTile`` that widens
its operands' sums (``KernelTile.widens``: float64 over float32 or bfloat16
operands). Without it the function is computed in the operands' own type.
With it the reference's Pallas cast placement holds (``src/repro/kernels/
{tttp,mttkrp,cg_matvec}.py``): the Hadamard chain of factor rows, and
``kr · x`` in the fused matvec, run in the compute type (float32 for
float32 and bfloat16 operands, as the CUDA kernels take it), each product
is cast to ``acc_dtype`` before it is summed, and every sum, the dot
products and ``z`` run in ``acc_dtype``. The result is in ``acc_dtype``;
``kernels.ops`` casts it back to the operands' type."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.tile import scatter_rows


def _compute(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the compute type of a widened sum: bfloat16 read as
    float32, as the CUDA kernels convert it in registers."""
    return t.float() if t.dtype == torch.bfloat16 else t


def tttp_ref(values: torch.Tensor, indices: torch.Tensor,
             valid: torch.Tensor,
             factors: Sequence[Optional[torch.Tensor]],
             acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x_n = values_n · Σ_r Π_j factors[j][indices[n, j], r] where
    ``valid[n]``, exactly 0 elsewhere."""
    prod = None
    for d, f in enumerate(factors):
        if f is None:
            continue
        rows = f[indices[:, d]] if acc_dtype is None else \
            _compute(f)[indices[:, d]]
        prod = rows if prod is None else prod * rows
    if acc_dtype is None:
        return torch.where(valid, values * prod.sum(dim=1), 0)
    partial = prod.to(acc_dtype).sum(dim=1)
    return torch.where(valid, values.to(acc_dtype) * partial, 0)


def _segment_sum(contrib: torch.Tensor, blocal: torch.Tensor,
                 block_rows: int) -> torch.Tensor:
    """Sum (nb, C, R) contributions into (nb·block_rows, R) output rows by
    the in-bucket local row, with the one-hot schedule of
    :func:`scatter_rows` (it takes the unsorted key ``blocal``; padding
    slots carry ``local_row`` 0 and a zero contribution)."""
    nb, _, r = contrib.shape
    out = scatter_rows(contrib, blocal, block_rows, "onehot", contrib.dtype)
    return out.reshape(nb * block_rows, r)


def _kr(factors, bindices, mode):
    """(nb, C, R) product of the non-target factors' rows in the compute
    type, or None when there is no such factor."""
    kr = None
    for d, f in enumerate(factors):
        if f is None or d == mode:
            continue
        rows = _compute(f)[bindices[:, :, d]]
        kr = rows if kr is None else kr * rows
    return kr


def mttkrp_bucketed_ref(bvalues: torch.Tensor, bindices: torch.Tensor,
                        blocal: torch.Tensor,
                        factors: Sequence[Optional[torch.Tensor]],
                        mode: int, block_rows: int,
                        acc_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Bucketed MTTKRP over RowBlockBuckets fields: (nb, C) values, (nb, C,
    nd) indices, (nb, C) local rows. Output (nb·block_rows, R). With
    ``acc_dtype`` the reference's Pallas order: (Π rows) · v in the compute
    type, then cast and summed."""
    nb, c = bvalues.shape
    if acc_dtype is not None:
        prod = _kr(factors, bindices, mode) * _compute(bvalues)[..., None]
        return _segment_sum(prod.to(acc_dtype), blocal, block_rows)
    r = next(f.shape[1] for f in factors if f is not None)
    prod = bvalues[..., None].expand(nb, c, r)
    for d, f in enumerate(factors):
        if f is None or d == mode:
            continue
        prod = prod * f[bindices[:, :, d]]
    return _segment_sum(prod, blocal, block_rows)


def cg_matvec_bucketed_ref(bomega: torch.Tensor, bindices: torch.Tensor,
                           blocal: torch.Tensor,
                           factors: Sequence[Optional[torch.Tensor]],
                           x: torch.Tensor, mode: int,
                           block_rows: int,
                           acc_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Fused implicit-CG Gram matvec (paper eq. 3, one pass):

        z_n = ω_n Σ_s (Π_{d≠mode} A_d[i_d, s]) x[i_mode, s]
        y[i, r] = Σ_{n in rows(i)} z_n Π_{d≠mode} A_d[i_d, r]

    Output (nb·block_rows, R); the caller slices to the true row count."""
    nb, c = bomega.shape
    r = x.shape[1]
    if acc_dtype is not None:
        xc = _compute(x)
        kr = _kr(factors, bindices, mode)
        if kr is None:
            kr = torch.ones(nb, c, r, dtype=xc.dtype, device=x.device)
        xrows = xc[bindices[:, :, mode]]
        z = bomega.to(acc_dtype) * (kr * xrows).to(acc_dtype).sum(dim=-1)
        return _segment_sum(z[..., None] * kr.to(acc_dtype), blocal,
                            block_rows)
    kr = torch.ones(nb, c, r, dtype=x.dtype, device=x.device)
    for d, f in enumerate(factors):
        if f is None or d == mode:
            continue
        kr = kr * f[bindices[:, :, d]]
    xrows = x[bindices[:, :, mode]]                       # (nb, C, R)
    z = bomega * (kr * xrows).sum(dim=-1)                 # (nb, C)
    return _segment_sum(z[..., None] * kr, blocal, block_rows)
