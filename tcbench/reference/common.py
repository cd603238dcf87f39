"""Sparse operations of the references on a coordinate list, and the
precision they compute in.

``idx`` is an (m, N) int32 tensor of coordinates, ``w`` an (m,) tensor of
per-entry values; factors are (I_d, R) matrices. TTTP runs over the list
in blocks of entries; the sums by row (MTTKRP, the per-row Gram matrices)
run as batched products over each mode's :class:`Rows` grid, made from the
list alone (no atomics, so a sum's order is fixed). Nothing here reads the
program's layouts, plans or kernels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

# elements of a block's largest temporary
BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Precision:
    """``compute`` is the type every sum runs in; ``store``, when set, is
    the type each stored array (inputs, factors, vectors, the output of
    each contraction) is rounded to: the control's bf16 operands over
    float32 sums."""
    compute: torch.dtype
    store: Optional[torch.dtype] = None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.store is not None:
            t = t.to(self.store)
        return t.to(self.compute)


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, torch.bfloat16)


def no_tf32() -> None:
    """Float32 products in full float32 (the control's bmm and matmul)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blocks(m: int, width: int):
    step = max(1, BLOCK_ELEMS // max(width, 1))
    for lo in range(0, m, step):
        yield lo, min(m, lo + step)


def _kr(idx: torch.Tensor, factors: Sequence[torch.Tensor],
        skip: Optional[int]) -> torch.Tensor:
    out = None
    for d, f in enumerate(factors):
        if d == skip:
            continue
        rows = f[idx[:, d].long()]
        out = rows if out is None else out * rows
    return out


class Rows:
    """The entries grouped by their index in one mode: a (rows, width)
    grid, each row's entries in their list order and then empty slots up to
    the fullest row's count. ``at[n]`` is entry n's place in the grid."""

    def __init__(self, idx: torch.Tensor, mode: int, rows: int):
        r = idx[:, mode].long()
        counts = torch.bincount(r, minlength=rows)
        self.rows, self.width = rows, int(counts.max())
        order = torch.argsort(r, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.empty_like(r)
        pos[order] = torch.arange(r.numel(), device=r.device) - \
            starts[r[order]]
        self.at = r * self.width + pos

    def grid(self, v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.rows * self.width,) + v.shape[1:],
                          dtype=v.dtype, device=v.device)
        out[self.at] = v
        return out.view((self.rows, self.width) + v.shape[1:])

    def coo(self, g: torch.Tensor) -> torch.Tensor:
        return g.reshape((self.rows * self.width,) + g.shape[2:])[self.at]


class Problem:
    """A coordinate list (``idx`` (m, N) int32, ``vals``), its extents and
    the initial factors, with each mode's :class:`Rows` made once."""

    def __init__(self, idx, vals, factors, shape):
        self.idx, self.vals, self.factors = idx, vals, factors
        self.shape = tuple(shape)
        self._rows = {}

    def rows(self, mode: int) -> Rows:
        if mode not in self._rows:
            self._rows[mode] = Rows(self.idx, mode, self.shape[mode])
        return self._rows[mode]


def tttp(idx: torch.Tensor, w: Optional[torch.Tensor],
         factors: Sequence[torch.Tensor], prec: Precision) -> torch.Tensor:
    """w_n · Σ_r Π_d A_d[i_d, r] per entry (w None: 1)."""
    rank = factors[0].shape[1]
    out = torch.empty(idx.shape[0], dtype=prec.compute, device=idx.device)
    for lo, hi in _blocks(idx.shape[0], rank):
        v = _kr(idx[lo:hi], factors, None).sum(1)
        out[lo:hi] = v if w is None else w[lo:hi] * v
    return prec(out)


def kr_grid(p: Problem, factors: Sequence[torch.Tensor],
            mode: int) -> torch.Tensor:
    """Every entry's Khatri-Rao row of the modes other than ``mode``, in
    that mode's grid: (rows, width, R), empty slots 0."""
    lay, rank = p.rows(mode), factors[0].shape[1]
    out = torch.zeros(lay.rows * lay.width, rank, dtype=factors[0].dtype,
                      device=p.idx.device)
    for lo, hi in _blocks(p.idx.shape[0], rank):
        out[lay.at[lo:hi]] = _kr(p.idx[lo:hi], factors, mode)
    return out.view(lay.rows, lay.width, rank)


def mttkrp(p: Problem, w: torch.Tensor, k: torch.Tensor, mode: int,
           prec: Precision) -> torch.Tensor:
    """Σ_{n: i_mode = i} w_n k_n for every row i, an (I, R) matrix, from
    the mode's Khatri-Rao grid ``k``."""
    wg = p.rows(mode).grid(w)
    return prec(torch.bmm(k.transpose(1, 2), wg[:, :, None])[:, :, 0])


def gram(p: Problem, w: Optional[torch.Tensor], k: torch.Tensor,
         mode: int) -> torch.Tensor:
    """The per-row Gram matrices Σ_{n: i_mode = i} w_n k_n k_nᵀ, (I, R, R),
    in the compute type (a sum, not a stored array)."""
    kw = k if w is None else k * p.rows(mode).grid(w)[:, :, None]
    return torch.bmm(kw.transpose(1, 2), k)


def gram_apply(g: torch.Tensor, x: torch.Tensor, shift: float,
               prec: Precision) -> torch.Tensor:
    """(G + shift·I) x, row by row."""
    return prec(torch.bmm(g, x[:, :, None])[:, :, 0] + shift * x)


def rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(1)


def batched_pcg(matvec, b: torch.Tensor, x0: torch.Tensor, precond,
                tol: float, iters: int, prec: Precision) -> torch.Tensor:
    """Batched-rows preconditioned CG for a fixed number of iterations; a
    row whose residual² falls to tol²·‖b_row‖² or below is frozen (α = β =
    0), as the paper's implicit CG stops it."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    thresh = (tol ** 2) * torch.clamp(rowdot(b, b), min=1e-30)
    x = x0
    r = prec(b - matvec(x0))
    z = prec(precond(r))
    p = z
    rz, rs = rowdot(r, z), rowdot(r, r)
    for _ in range(iters):
        active = rs > thresh
        ap = matvec(p)
        pap = rowdot(p, ap)
        alpha = torch.where(active, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        x = prec(x + alpha[:, None] * p)
        r = prec(r - alpha[:, None] * ap)
        z = prec(precond(r))
        rz_new = rowdot(r, z)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0),
                           0.0)
        p = prec(z + beta[:, None] * p)
        rz = rz_new
        rs = rowdot(r, r)
    return x


def rmse(p: Problem, factors: Sequence[torch.Tensor],
         prec: Precision) -> float:
    d = p.vals - tttp(p.idx, None, factors, prec)
    return float(torch.sqrt((d * d).sum() / max(p.idx.shape[0], 1)))


def rel_gap(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    """‖got − want‖ / max(‖want‖, floor), in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want)) / max(
        float(torch.linalg.norm(want)), floor, 1e-300)


def factor_gap(got: Sequence[torch.Tensor],
               want: Sequence[torch.Tensor]) -> float:
    """The worst factor's ‖A − A_ref‖ / max(‖A_ref‖, the median factor's
    norm)."""
    norms = sorted(float(torch.linalg.norm(w.double())) for w in want)
    median = norms[len(norms) // 2]
    return max(rel_gap(g.to(w.device), w, median)
               for g, w in zip(got, want))


def row_gap(got: Sequence[torch.Tensor],
            want: Sequence[torch.Tensor]) -> float:
    """The worst factor row's ‖a_i − a_i,ref‖ / max(‖a_i,ref‖, its
    factor's median row norm): one row altered reads about 1."""
    out = 0.0
    for g, w in zip(got, want):
        w = w.double()
        norms = torch.linalg.norm(w, dim=1)
        floor = torch.clamp(norms, min=float(norms.median()))
        gap = torch.linalg.norm(g.double().to(w.device) - w, dim=1) / floor
        out = max(out, float(gap.max()))
    return out


def to_reference(factors: Sequence[torch.Tensor],
                 prec: Precision) -> List[torch.Tensor]:
    return [prec(f) for f in factors]
