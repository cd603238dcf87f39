"""Synthetic datasets, drawn from an explicit ``torch.Generator`` on the
generator's own device (so a paper-scale tensor is made on the card).

* ``function_tensor`` — the Karlsson et al. model problem of paper Fig. 7a:
  t_i = sigmoid(3 · Σ_d x_d[i_d]) with x_d ~ U[-1, 1] at i.i.d. uniform
  indices; smooth, so its effective CP rank is low.
* ``netflix_like`` — a Netflix-shaped tensor (users × movies × time,
  480,189 × 17,770 × 2,182 at full scale): integer ratings 1..5 with
  Zipf-distributed user and movie popularity and a low-rank bias
  structure, mirroring the real dataset's statistics (Fig. 7b).

The reference draws from ``jax.random``; the two streams differ, so the port
matches the reference in distribution only. Parity tests share arrays
through numpy instead (``repro_torch.interop``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import round_up

NETFLIX_SHAPE = (480_189, 17_770, 2_182)
NETFLIX_NNZ = 100_477_727


def function_tensor(shape: Tuple[int, ...], nnz: int,
                    generator: torch.Generator,
                    cap: Optional[int] = None) -> SparseTensor:
    dev = generator.device
    idx_cols = [torch.randint(0, s, (nnz,), generator=generator, device=dev,
                              dtype=torch.int32) for s in shape]
    grids = [torch.rand(s, generator=generator, device=dev) * 2.0 - 1.0
             for s in shape]
    arg = sum(g[i] for g, i in zip(grids, idx_cols))
    vals = torch.sigmoid(3.0 * arg)
    return SparseTensor.from_coo(torch.stack(idx_cols, dim=1), vals, shape,
                                 cap=cap)


def _zipf_choice(n: int, size: int, a: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Zipf-distributed ranks in [0, n) by inverse CDF (int64)."""
    dev = generator.device
    w = torch.arange(1, n + 1, dtype=torch.float64, device=dev) ** (-a)
    cdf = torch.cumsum(w, 0) / torch.sum(w)
    u = torch.rand(size, generator=generator, device=dev,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(0, n - 1)


def _first_occurrences(lin: torch.Tensor) -> torch.Tensor:
    """Positions of the first occurrence of each distinct value of ``lin``,
    in increasing order."""
    uniq, inv = torch.unique(lin, return_inverse=True)
    pos = torch.arange(lin.numel(), device=lin.device)
    first = torch.full((uniq.numel(),), lin.numel(), dtype=torch.int64,
                       device=lin.device)
    first.scatter_reduce_(0, inv, pos, reduce="amin")
    return torch.sort(first).values


def netflix_like(shape: Optional[Tuple[int, int, int]] = None,
                 nnz: int = 1_000_000,
                 generator: Optional[torch.Generator] = None,
                 cap: Optional[int] = None, zipf_a: float = 1.1,
                 max_rounds: int = 64) -> SparseTensor:
    """Netflix-shaped ratings tensor with popularity skew and low-rank bias
    structure; values are integer ratings in 1..5, on the generator's
    device (a ``cuda`` generator seeded 0 when none is given).

    Zipf sampling repeats coordinates often (popular users × popular
    movies), and Ω must be a set. Coordinates are therefore drawn in rounds
    of oversampling and deduplicated, the first occurrence winning, until
    exactly ``nnz`` distinct coordinates exist; the result has exactly
    ``nnz`` valid entries. Raises ValueError when ``nnz`` exceeds the cells
    of ``shape`` and RuntimeError when ``max_rounds`` do not collect them."""
    shape = shape or NETFLIX_SHAPE
    i_dim, j_dim, k_dim = shape
    cells = i_dim * j_dim * k_dim
    if nnz > cells:
        raise ValueError(f"nnz={nnz} exceeds the {cells} cells of {shape}")
    if generator is None:
        generator = torch.Generator(device="cuda").manual_seed(0)
    dev = generator.device
    seen = torch.zeros(0, dtype=torch.int64, device=dev)
    coords = []
    have = 0
    for _ in range(max_rounds):
        need = nnz - have
        if need <= 0:
            break
        # oversample: dedup discards a share that grows with density
        draw = min(max(2 * need, 1024), 8 * nnz)
        ii = _zipf_choice(i_dim, draw, zipf_a, generator)
        jj = _zipf_choice(j_dim, draw, zipf_a, generator)
        kk = torch.randint(0, k_dim, (draw,), generator=generator,
                           device=dev)
        lin = (ii * j_dim + jj) * k_dim + kk
        # first occurrence within the round, then drop coordinates seen in
        # earlier rounds
        first = _first_occurrences(lin)
        fresh = first[~torch.isin(lin[first], seen)][:need]
        coords.append(torch.stack([ii[fresh], jj[fresh], kk[fresh]], 1))
        seen = torch.cat([seen, lin[fresh]])
        have += fresh.numel()
    if have < nnz:
        raise RuntimeError(f"could not collect {nnz} unique coordinates in "
                           f"{max_rounds} rounds (density too high?)")
    idx = torch.cat(coords).to(torch.int32)
    ii, jj, kk = (idx[:, d].long() for d in range(3))
    r = 4
    bu = 0.5 * torch.randn(i_dim, r, generator=generator, device=dev)
    bv = 0.5 * torch.randn(j_dim, r, generator=generator, device=dev)
    bw = 0.2 * torch.randn(k_dim, r, generator=generator, device=dev)
    base = 3.5 + torch.sum(bu[ii] * bv[jj] * (1.0 + bw[kk]), dim=1)
    noise = 0.4 * torch.randn(nnz, generator=generator, device=dev)
    vals = torch.clamp(torch.round(base + noise), 1.0, 5.0)
    return SparseTensor.from_coo(idx, vals, shape, cap=cap)


def shuffle_and_pad(st: SparseTensor, generator: torch.Generator,
                    num_shards: int = 1) -> SparseTensor:
    """Pad capacity to a multiple of ``num_shards`` and shuffle all entries,
    padding included, so shard loads and padding are balanced."""
    cap = round_up(st.cap, num_shards)
    idx = torch.cat([st.indices, st.indices.new_zeros(cap - st.cap,
                                                      st.ndim)])
    vals = torch.cat([st.values, st.values.new_zeros(cap - st.cap)])
    valid = torch.cat([st.valid, st.valid.new_zeros(cap - st.cap)])
    perm = torch.randperm(cap, generator=generator, device=generator.device)
    return SparseTensor(idx[perm], vals[perm], valid[perm], st.shape, st.nnz)
