"""Plain PyTorch versions of the three CUDA kernels. The wrappers in
``kernels.ops`` run these for tensors on the CPU; the card's smoke test
holds each kernel against them on the same inputs."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.tile import scatter_rows


def tttp_ref(values: torch.Tensor, indices: torch.Tensor,
             factors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """x_n = values_n · Σ_r Π_j factors[j][indices[n, j], r]."""
    prod = None
    for d, f in enumerate(factors):
        if f is None:
            continue
        rows = f[indices[:, d]]
        prod = rows if prod is None else prod * rows
    return values * prod.sum(dim=1)


def _segment_sum(contrib: torch.Tensor, blocal: torch.Tensor,
                 block_rows: int) -> torch.Tensor:
    """Sum (nb, C, R) contributions into (nb·block_rows, R) output rows by
    the in-bucket local row, with the one-hot schedule of
    :func:`scatter_rows` (it takes the unsorted key ``blocal``; padding
    slots carry ``local_row`` 0 and a zero contribution)."""
    nb, _, r = contrib.shape
    out = scatter_rows(contrib, blocal, block_rows, "onehot", contrib.dtype)
    return out.reshape(nb * block_rows, r)


def mttkrp_bucketed_ref(bvalues: torch.Tensor, bindices: torch.Tensor,
                        blocal: torch.Tensor,
                        factors: Sequence[Optional[torch.Tensor]],
                        mode: int, block_rows: int) -> torch.Tensor:
    """Bucketed MTTKRP over RowBlockBuckets fields: (nb, C) values, (nb, C,
    nd) indices, (nb, C) local rows. Output (nb·block_rows, R)."""
    nb, c = bvalues.shape
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
                           block_rows: int) -> torch.Tensor:
    """Fused implicit-CG Gram matvec (paper eq. 3, one pass):

        z_n = ω_n Σ_s (Π_{d≠mode} A_d[i_d, s]) x[i_mode, s]
        y[i, r] = Σ_{n in rows(i)} z_n Π_{d≠mode} A_d[i_d, r]

    Output (nb·block_rows, R); the caller slices to the true row count."""
    nb, c = bomega.shape
    r = x.shape[1]
    kr = torch.ones(nb, c, r, dtype=x.dtype, device=x.device)
    for d, f in enumerate(factors):
        if f is None or d == mode:
            continue
        kr = kr * f[bindices[:, :, d]]
    xrows = x[bindices[:, :, mode]]                       # (nb, C, R)
    z = bomega * (kr * xrows).sum(dim=-1)                 # (nb, C)
    return _segment_sum(z[..., None] * kr, blocal, block_rows)
