"""Synthetic datasets, drawn from an explicit ``torch.Generator`` on the
generator's own device (so a paper-scale tensor is made on the card).

* ``function_tensor`` — the Karlsson et al. model problem of paper Fig. 7a:
  t_i = sigmoid(3 · Σ_d x_d[i_d]) with x_d ~ U[-1, 1] at i.i.d. uniform
  indices; smooth, so its effective CP rank is low.

The reference draws from ``jax.random``; the two streams differ, so the port
matches the reference in distribution only. Parity tests share arrays
through numpy instead (``repro_torch.interop``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import round_up


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
