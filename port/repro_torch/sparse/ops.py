"""Sparse × dense contraction paths and hypersparse block summation (the
paper's §3.1 kernel set), in plain PyTorch as the reference's are plain
``jnp``:

* TTM (tensor-times-matrix) with three output representations (paper
  Fig. 5a): fully dense, sparse input with dense output, and hypersparse
  (sparse output over compressed keys);
* all-at-once and pairwise MTTKRP (Fig. 5b). The main path runs the
  bucketed MTTKRP kernel instead (``kernels.ops.mttkrp_bucketed``); the
  all-at-once :func:`mttkrp` here is the independent second oracle the
  tests hold it against;
* the sum of two sparse tensors with different patterns (union pattern),
  the local kernel of the paper's butterfly sparse reduction (Fig. 1);
* SDDMM, the order-2 TTTP.

Capacities stay static: outputs are padded like their inputs. Segment sums
are ``index_add_``; every function is differentiable in the values and the
dense operands by autograd.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import lex_sort_perm, linearize, rows_equal


def _other_modes(ndim: int, mode: int) -> List[int]:
    return [d for d in range(ndim) if d != mode]


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids.long(), vals)


def _compress(keys_s: torch.Tensor, mask_s: torch.Tensor):
    """Over lexicographically sorted keys (invalid rows last): which rows
    start a new key, and each row's compressed key slot."""
    prev = torch.cat([torch.full((1, keys_s.shape[1]), -1,
                                 dtype=keys_s.dtype, device=keys_s.device),
                      keys_s[:-1]], dim=0)
    is_start = ~rows_equal(keys_s, prev) & mask_s
    return is_start, torch.cumsum(is_start.long(), 0) - 1


def _compressed_tensor(idx_s: torch.Tensor, vals_s: torch.Tensor,
                       mask_s: torch.Tensor, shape) -> SparseTensor:
    """Sum the values of equal sorted keys into their first slots; the
    unique keys fill the leading slots, the rest is padding."""
    cap = idx_s.shape[0]
    is_start, crow = _compress(idx_s, mask_s)
    out_vals = _segment_sum(vals_s, torch.where(mask_s, crow, cap),
                            cap + 1)[:cap]
    out_idx = torch.zeros((cap + 1, idx_s.shape[1]), dtype=torch.int32,
                          device=idx_s.device)
    out_idx[torch.where(is_start, crow, cap)] = idx_s.to(torch.int32)
    out_valid = torch.arange(cap, device=idx_s.device) < is_start.sum()
    vmask = out_valid if out_vals.dim() == 1 else out_valid[:, None]
    return SparseTensor(out_idx[:cap], torch.where(vmask, out_vals, 0),
                        out_valid, tuple(shape))


# ---------------------------------------------------------------------------
# TTM: z_{i..r} = Σ_k t_{i..k..} w_{kr}
# ---------------------------------------------------------------------------

def ttm_dense_output(st: SparseTensor, w: torch.Tensor,
                     mode: int) -> torch.Tensor:
    """Sparse input, dense output: scatter-add into the full dense tensor.
    Memory Θ(Π_{d≠mode} I_d · R) (paper Fig. 5a, 'sparse, dense output')."""
    others = _other_modes(st.ndim, mode)
    contrib = st.masked_values()[:, None] * w[st.indices[:, mode]]
    out = torch.zeros(tuple(st.shape[d] for d in others) + (w.shape[1],),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_put_(tuple(st.indices[:, d].long() for d in others),
                          contrib, accumulate=True)


def ttm_hypersparse(st: SparseTensor, w: torch.Tensor,
                    mode: int) -> SparseTensor:
    """Sparse input, sparse output over the compressed uncontracted keys:
    Θ(m) storage with a trailing dense R axis, never Θ(Π I_d). Sort by the
    merged key, mark the unique keys (CCSR compression), segment-sum the
    contributions."""
    others = _other_modes(st.ndim, mode)
    perm = lex_sort_perm(st.indices, st.mask, others)
    contrib = (st.masked_values()[:, None] * w[st.indices[:, mode]])[perm]
    return _compressed_tensor(st.indices[perm][:, others], contrib,
                              st.mask[perm],
                              tuple(st.shape[d] for d in others))


def ttm_fully_dense(t_dense: torch.Tensor, w: torch.Tensor,
                    mode: int) -> torch.Tensor:
    """Dense baseline (paper Fig. 5a, 'dense')."""
    return torch.einsum("...k,kr->...r", torch.movedim(t_dense, mode, -1), w)


# ---------------------------------------------------------------------------
# MTTKRP: y_{ir} = Σ_{jk} t_{ijk} v_{jr} w_{kr}  (order-N generalization)
# ---------------------------------------------------------------------------

def mttkrp(st: SparseTensor, factors: Sequence[torch.Tensor],
           mode: int) -> torch.Tensor:
    """y[i, r] = Σ_{n: idx[n, mode] = i} v_n Π_{d≠mode} A_d[idx[n, d], r]:
    gather → product → ``index_add_``, a transient (cap, R) product."""
    prod = st.masked_values()[:, None]
    for d in _other_modes(st.ndim, mode):
        prod = prod * factors[d][st.indices[:, d]]
    return _segment_sum(prod, st.indices[:, mode], st.shape[mode])


def mttkrp_pairwise_t_first(st: SparseTensor, factors: Sequence[torch.Tensor],
                            mode: int) -> torch.Tensor:
    """Pairwise path contracting T with one factor first (hypersparse
    intermediate), then the rest (paper Fig. 5b, 'contract with T first')."""
    last = _other_modes(st.ndim, mode)[-1]
    z = ttm_hypersparse(st, factors[last], last)  # keys: modes except last
    key_modes = _other_modes(st.ndim, last)
    prod = z.values
    for d in range(st.ndim):
        if d not in (mode, last):
            prod = prod * factors[d][z.indices[:, key_modes.index(d)]]
    return _segment_sum(prod, z.indices[:, key_modes.index(mode)],
                        st.shape[mode])


def mttkrp_pairwise_kr_first(st: SparseTensor,
                             factors: Sequence[torch.Tensor],
                             mode: int) -> torch.Tensor:
    """Pairwise path forming the Khatri-Rao product first (a dense
    Θ(Π_{d≠mode} I_d · R) intermediate): efficient only for relatively
    dense tensors (paper §5.3)."""
    others = _other_modes(st.ndim, mode)
    kr = factors[others[0]]
    for d in others[1:]:
        kr = (kr[:, None, :] * factors[d][None, :, :]).reshape(-1,
                                                               kr.shape[-1])
    key = linearize(st.indices[:, others], [st.shape[d] for d in others])
    contrib = st.masked_values()[:, None] * kr[key]
    return _segment_sum(contrib, st.indices[:, mode], st.shape[mode])


# ---------------------------------------------------------------------------
# Hypersparse block summation (union of patterns), paper Fig. 1
# ---------------------------------------------------------------------------

def sparse_add_union(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Sum two sparse tensors with (possibly) different patterns. Output
    capacity a.cap + b.cap; duplicate coordinates merge by a sorted segment
    sum (the reference's stand-in for the paper's dense-buffer row merge)."""
    if a.shape != b.shape:
        raise ValueError(f"sparse_add_union: shapes {a.shape} and {b.shape}")
    idx = torch.cat([a.indices, b.indices], dim=0)
    vals = torch.cat([a.masked_values(), b.masked_values()], dim=0)
    mask = torch.cat([a.mask, b.mask], dim=0)
    perm = lex_sort_perm(idx, mask, range(idx.shape[1]))
    return _compressed_tensor(idx[perm], vals[perm], mask[perm], a.shape)


# ---------------------------------------------------------------------------
# SDDMM: TTTP with N = 2 (paper §3.2), X = S ⊙ (U Vᵀ)
# ---------------------------------------------------------------------------

def sddmm(s: SparseTensor, u: torch.Tensor, v: torch.Tensor) -> SparseTensor:
    if s.ndim != 2:
        raise ValueError(f"sddmm takes an order-2 tensor, got order {s.ndim}")
    ii, jj = s.indices[:, 0], s.indices[:, 1]
    return s.with_values(s.values * torch.sum(u[ii] * v[jj], dim=-1))
