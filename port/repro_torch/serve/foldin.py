"""Per-user fold-in: a damped one-row ALS against frozen factors.

A cold request comes with a short history (observed entries over the other
modes) and needs a factor row now, without touching the trained model. The
row solves the regularized normal equations one ALS mode update solves
(paper §2.2), restricted to one row:

    (G_u + λI) x_u = b_u,   b_u = MTTKRP(history, frozen factors)
    G_u x = MTTKRP(TTTP(Ω_u, [.., x, ..]), frozen factors)   (eq. 3)

so fold-in reuses the training machinery: the B requests of a batch are
packed as the B rows of one SparseTensor whose ``mode`` extent is the batch
slot, and one batched one-row ALS update solves all of them. Both halves
run over the history's CCSR bucket view (``block_rows`` 8): b is the
bucketed MTTKRP kernel, each CG matvec the fused CG-matvec kernel
(``matvec_path`` None or ``"fused"``) or TTTP then the MTTKRP
(``"tttp_mttkrp"``), through ``als.bucket_gram_matvec``; the planner's
candidates (``"auto"``, ``"sliced"``, ``"dense"``) run it through
``planner.planned_cg_matvec`` over the same view
(``SparseTensor.from_buckets``).
:func:`solve_buckets` takes the bucket views themselves, so the serving
engine can capture it over static buffers in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.completion import als
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import round_up
from repro_torch.kernels import ops as kops

History = Tuple[np.ndarray, np.ndarray]   # (other-mode indices, values)

# output rows per CCSR bucket of a packed history: one CTA of the bucketed
# kernels owns this many users
BLOCK_ROWS = 8


def matvec_route(matvec_path: Optional[str]) -> str:
    """The ``als`` matvec route of a fold-in ``matvec_path``: None and
    ``"fused"`` take the fused kernel, ``"tttp_mttkrp"`` TTTP then the
    MTTKRP, ``"auto"``, ``"sliced"`` and ``"dense"`` the planner."""
    if matvec_path is None:
        return "fused"
    if matvec_path not in als.MATVEC_PATHS:
        raise ValueError(f"matvec_path {matvec_path!r} not in "
                         f"{(None,) + als.MATVEC_PATHS}")
    return matvec_path


def pack_histories(histories: Sequence[History], shape: Sequence[int],
                   mode: int, cap: Optional[int] = None,
                   pad_multiple: int = 8, device="cuda") -> SparseTensor:
    """Pack per-user histories into one SparseTensor on ``device`` whose
    ``mode`` extent is the batch slot.

    Each history is ``(other_idx, values)``, ``other_idx`` (n_u, ndim-1)
    indexing the modes other than ``mode`` in ascending order. The entry
    capacity is ``cap`` or the entry count rounded up to ``pad_multiple``.
    Raises if an index lies outside its mode."""
    ndim = len(shape)
    others = [d for d in range(ndim) if d != mode]
    idx_rows: List[np.ndarray] = []
    val_rows: List[np.ndarray] = []
    for slot, (other_idx, values) in enumerate(histories):
        values = np.asarray(values, np.float32).reshape(-1)
        other_idx = np.asarray(other_idx, np.int32).reshape(
            values.shape[0], ndim - 1)
        idx = np.zeros((values.shape[0], ndim), np.int32)
        idx[:, others] = other_idx
        idx[:, mode] = slot
        idx_rows.append(idx)
        val_rows.append(values)
    indices = np.concatenate(idx_rows, axis=0)
    values = np.concatenate(val_rows, axis=0)
    for d in others:
        lo, hi = indices[:, d].min(initial=0), indices[:, d].max(initial=0)
        if lo < 0 or hi >= shape[d]:
            raise ValueError(f"history index out of range on mode {d}: "
                             f"[{lo}, {hi}] vs extent {shape[d]}")
    st_shape = tuple(len(histories) if d == mode else int(shape[d])
                     for d in range(ndim))
    return SparseTensor.from_coo(indices, values, st_shape, cap=cap,
                                 pad_multiple=pad_multiple, device=device)


def cg_budget(rank: int) -> int:
    """Fold-in's default CG iterations at rank R: max(4R, 32)."""
    return max(4 * rank, 32)


def solve_buckets(buckets, omega_buckets, factors: Sequence[torch.Tensor],
                  lam: float = 1e-2, cg_tol: float = 1e-6,
                  cg_iters: Optional[int] = None, matvec_path: str = "fused",
                  x0: Optional[torch.Tensor] = None, out=None):
    """Batched one-row damped ALS over a packed history's bucket views
    along their mode: ``buckets`` hold the ratings, ``omega_buckets`` (the
    same pattern) the weights ω. Returns ``(rows (B, R), iters)``, B the
    history tensor's extent in that mode and ``iters`` a device tensor:
    the CG iterations in which some row was active. ``cg_iters`` defaults
    to max(4R, 32); converged rows are frozen (``als.batched_cg``).
    ``out`` (rows, iters) receives both (:func:`packed_rows`)."""
    mode = buckets.mode
    fs = list(factors)
    others = [d for d in range(len(fs)) if d != mode]
    if any(fs[d] is None for d in others):
        raise ValueError("fold-in needs a frozen factor on every other mode")
    r = int(fs[others[0]].shape[1])
    batch = int(buckets.shape[mode])
    cg_iters = cg_budget(r) if cg_iters is None else cg_iters
    b_factors = [None if d == mode else fs[d] for d in range(len(fs))]
    b = kops.mttkrp_bucketed(buckets, b_factors, num_rows=batch)   # (B, R)
    if matvec_path in als.DIRECT_MATVEC_PATHS:
        mv = functools.partial(als.bucket_gram_matvec, omega_buckets, fs,
                               lam=lam, matvec_path=matvec_path)
    else:
        # the planner reads the same view: from_buckets hands it over
        # cached, so nothing is bucketed again
        mv = functools.partial(als.gram_matvec,
                               SparseTensor.from_buckets(omega_buckets), fs,
                               mode, lam=lam, matvec_path=matvec_path,
                               block_rows=omega_buckets.block_rows)
    if x0 is None:
        x0 = torch.zeros((batch, r), dtype=b.dtype, device=b.device)
    return als.batched_cg(mv, b, x0, tol=cg_tol, max_iters=cg_iters,
                          out=out)


def _count_offset(n: int, itemsize: int) -> int:
    """Elements of a packed buffer before its count: ``n`` rows' elements
    rounded up to a 4-byte boundary."""
    return -(-n * itemsize // 4) * 4 // itemsize


def packed_rows(batch: int, rank: int, dtype: torch.dtype,
                device="cuda") -> tuple:
    """One flat buffer for a batch's rows (B, R) and, after them on a
    4-byte boundary, a 0-d int32 count, so that one copy reads both:
    ``(flat, (rows, count))``, the pair as :func:`solve_buckets`'s
    ``out``; :func:`unpack_rows` splits a copy of ``flat``."""
    off = _count_offset(batch * rank, dtype.itemsize)
    flat = torch.empty(off + max(1, 4 // dtype.itemsize), dtype=dtype,
                       device=device)
    return flat, unpack_rows(flat, batch, rank)


def unpack_rows(flat: torch.Tensor, batch: int, rank: int) -> tuple:
    """``(rows (B, R), count)`` of a :func:`packed_rows` buffer, as views
    of ``flat``."""
    off = _count_offset(batch * rank, flat.element_size())
    return (flat[:batch * rank].view(batch, rank),
            flat[off:].view(torch.int32)[0])


def omega_view(buckets):
    """The Ω bucket view of a history's bucket view: weight 1 on every
    valid slot."""
    return dataclasses.replace(buckets,
                               values=buckets.valid.to(buckets.values.dtype))


def fold_in(st_hist: SparseTensor, factors: Sequence[torch.Tensor],
            mode: int, lam: float = 1e-2, cg_tol: float = 1e-6,
            cg_iters: Optional[int] = None,
            matvec_path: Optional[str] = None,
            weights: Optional[torch.Tensor] = None,
            x0: Optional[torch.Tensor] = None):
    """Solve the batched one-row damped ALS systems; returns ``(rows
    (B, R), iters)``.

    ``st_hist`` is a :func:`pack_histories` tensor (``shape[mode]`` = B).
    ``weights`` gives per-entry ω_n (confidence weights, or a loss
    curvature); the default is the Ω indicator. CG on an R×R SPD system
    ends in R steps only in exact arithmetic; in float32 on a fitted,
    ill-scaled Gram it does not, so the budget is max(4R, 32) and the
    ``cg_tol`` relative residual decides when a row is done."""
    route = matvec_route(matvec_path)
    bk = st_hist.row_buckets(mode, BLOCK_ROWS)
    bo = (omega_view(bk) if weights is None else
          st_hist.with_values(weights).row_buckets(mode, BLOCK_ROWS))
    return solve_buckets(bk, bo, factors, lam, cg_tol, cg_iters, route, x0)


def fold_in_single(factors: Sequence[torch.Tensor], mode: int,
                   other_idx, values, shape: Sequence[int],
                   **kw) -> torch.Tensor:
    """One user's fold-in row (R,), on the factors' device: the batched
    path with B = 1."""
    device = next(f.device for d, f in enumerate(factors)
                  if d != mode and f is not None)
    st = pack_histories([(other_idx, values)], shape, mode,
                        cap=round_up(max(len(np.asarray(values)), 1), 8),
                        device=device)
    rows, _ = fold_in(st, factors, mode, **kw)
    return rows[0]
