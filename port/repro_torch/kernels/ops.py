"""Wrappers that dispatch the three sparse kernels by the tensors' device,
and the Gram-matvec schedules built on them over a bucket view
(:func:`bucket_matvec`), shared by the solvers and the planner.

A CUDA tensor goes to the hand-written kernel (``kernels.tttp``,
``kernels.mttkrp``, ``kernels.cg_matvec``), which launches or raises; a CPU
tensor goes to the plain PyTorch version in ``kernels.ref``. There is no
switch and no fallback between the two.

Element types follow the reference (``kernels/ops.py:_out_dtype``): the
kernels take float32, bfloat16 or float64 operands, keep the Hadamard chain
in float32 for the first two and in float64 for the third, sum in the
tile's accumulator (the reference's ``KernelTile.accum_dtype``: float32 or
float64 for the first two, float64 always for the third), and write their
operands' type; a result has the promoted type of the values (x for the
Gram matvec) and the factors, on either device. On the CPU the plain
versions take the same accumulator (``kernels.ref``'s ``acc_dtype``), so
both devices compute the reference's function. Mixed inputs are promoted
on the card before the launch, over every floating operand
(``torch.result_type``'s rule, the reference's ``jnp.result_type``): each
kernel takes one element type. A
type no instantiation takes (float16) raises on the card. Results keep
the reference's shapes: the kernels write padded outputs (``nb·block_rows``
rows for the bucketed ones), which are sliced back to ``num_rows``. The
reference also padded the nonzero and capacity axes to its Pallas tile
multiples; the CUDA kernels mask their ragged edge themselves, so those
pads are not carried over.

Launch shapes: each wrapper takes ``tile=``, a ``kernels.tile.KernelTile``
(threads per CTA, slots or nonzeros per thread); an explicit tile wins,
otherwise the family's entry of the process-wide table
(``tile.current_tile``, where ``planner.tuner`` installs measured winners).
The CPU's plain versions ignore the launch knobs. Each call runs in an
``obs`` span ``kernel/<family>`` that carries ``tile=<short>``.

Each kernel module counts its launches in a plain integer ``launches`` and
keeps the (threads, per_thread) of its last launch in ``last_launch``
(:func:`last_launches`); :func:`launch_counts` reads the counts and
:func:`reset_launch_counts` zeroes them.
A wrapper called while a CUDA graph captures launches nothing: the graph
launches its kernels at each replay. :func:`recorded_launches` takes such
calls back out of the counts and hands them to the caller, which adds them
at every replay with :func:`add_launches`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import cg_matvec as kcg
from repro_torch.kernels import mttkrp as kmttkrp
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tile as ktile
from repro_torch.kernels import tttp as ktttp

_MODULES = {"tttp": ktttp, "mttkrp": kmttkrp, "cg_matvec": kcg}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
        for k in mod.launches_by_dtype:
            mod.launches_by_dtype[k] = 0


def last_launches() -> Dict[str, Optional[tuple]]:
    """Per kernel, the (threads, per_thread) of its last launch (None
    before the first): what shows that a tile reached the kernel."""
    return {name: mod.last_launch for name, mod in _MODULES.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the counts: what one
    replay of a captured graph launched."""
    for name, n in counts.items():
        _MODULES[name].launches += n


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: on exit the counts are what they were on
    entry, and the dict yielded holds the launches the wrappers recorded
    inside, which the graph makes at each replay."""
    before = launch_counts()
    by_dtype = launch_counts_by_dtype()
    held: Dict[str, int] = {}
    try:
        yield held
    finally:
        for name, n in launch_counts().items():
            held[name] = n - before[name]
            _MODULES[name].launches = before[name]
            _MODULES[name].launches_by_dtype.update(by_dtype[name])


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _promoted(*tensors) -> torch.dtype:
    """The promoted element type of the tensors given (None skipped): the
    reference's ``jnp.result_type`` over the same operands."""
    return functools.reduce(torch.promote_types,
                            [t.dtype for t in tensors if t is not None])


def _out_dtype(first: torch.Tensor, factors) -> torch.dtype:
    """The reference's ``_out_dtype``: the promoted type of ``first`` (the
    values, or x for the Gram matvec) and the present factors."""
    return _promoted(first, *factors)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    """Per kernel, its launches split by element type and accumulator
    (``float32``, ``bfloat16``, ``float64`` in their own accumulator,
    ``float32/float64`` and ``bfloat16/float64`` summed in float64), zeroed
    with the counts: what shows which instantiation ran. Eager launches
    only: a graph replay adds to the totals alone."""
    return {name: dict(mod.launches_by_dtype)
            for name, mod in _MODULES.items()}


def _resolve_tile(family: str,
                  tile: Optional[ktile.KernelTile]) -> ktile.KernelTile:
    return tile if tile is not None else ktile.current_tile(family)


def _plain_acc(tile: ktile.KernelTile,
               dtype: torch.dtype) -> Optional[torch.dtype]:
    """``acc_dtype`` of the plain versions for ``dtype`` operands under
    ``tile``: its accumulator where it widens them, else None."""
    return tile.accumulator(dtype) if tile.widens(dtype) else None


def _refuse_grad(kernel: str, *tensors) -> None:
    """The CUDA kernels have no backward (nor have the reference's Pallas
    kernels): with grad mode on, an input that requires grad raises rather
    than leaving an output without a ``grad_fn``, a silently wrong
    gradient. On the CPU the plain versions differentiate by autograd."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            raise RuntimeError(
                f"the {kernel} CUDA kernel has no backward, but an input "
                f"requires grad: detach the inputs or run under "
                f"torch.no_grad() (the CPU's plain versions differentiate)")


def _tttp(values: torch.Tensor, indices: torch.Tensor, valid: torch.Tensor,
          factors: Sequence[Optional[torch.Tensor]],
          tile: Optional[ktile.KernelTile]) -> torch.Tensor:
    """TTTP over flat (m,) slots, 0 where ``valid`` is false. Vector factors
    are promoted to single-column matrices."""
    factors = [None if f is None else (f[:, None] if f.dim() == 1 else f)
               for f in factors]
    t = _resolve_tile("tttp", tile)
    dt = _out_dtype(values, factors)
    with obs.span("kernel/tttp", m=values.shape[0], tile=t.short()) as sp:
        if not _on_card(values):
            return sp.fence(kref.tttp_ref(values, indices, valid, factors,
                                          _plain_acc(t, dt)).to(dt))
        _refuse_grad("TTTP", values, *factors)
        return sp.fence(ktttp.tttp_cuda(
            _cast(values, dt), indices, valid,
            [_cast(f, dt) for f in factors], t))


def tttp_values(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
                tile: Optional[ktile.KernelTile] = None) -> torch.Tensor:
    """TTTP output values for a padded-COO SparseTensor, 0 on padding."""
    return _tttp(st.values, st.indices, st.valid, factors, tile)


def tttp_bucket_values(buckets, factors: Sequence[Optional[torch.Tensor]],
                       tile: Optional[ktile.KernelTile] = None
                       ) -> torch.Tensor:
    """TTTP over a CCSR bucket view (``RowBlockBuckets``): its nb·C slots
    flattened, so the same kernel runs on them. Returns (nb, C) in bucket
    order, 0 on padding slots: the values of a bucket view of the COO
    result, with no gather through the pattern."""
    nb, c, nd = buckets.indices.shape
    out = _tttp(buckets.values.reshape(nb * c),
                buckets.indices.reshape(nb * c, nd),
                buckets.valid.reshape(nb * c), factors, tile)
    return out.view(nb, c)


def tttp(st: SparseTensor, factors) -> SparseTensor:
    return st.with_values(tttp_values(st, factors))


def mttkrp_bucketed(buckets, factors: Sequence[Optional[torch.Tensor]],
                    num_rows: Optional[int] = None,
                    tile: Optional[ktile.KernelTile] = None) -> torch.Tensor:
    """All-at-once MTTKRP over ingest-time buckets; returns (num_rows, R)
    in the promoted type of the values and the factors. On the card any R:
    one launch per column tile of at most ``kernels.mttkrp.MAX_RANK``
    columns."""
    num_rows = num_rows or buckets.shape[buckets.mode]
    t = _resolve_tile("mttkrp", tile)
    dt = _out_dtype(buckets.values, factors)
    with obs.span("kernel/mttkrp_bucketed", mode=buckets.mode,
                  rows=num_rows, tile=t.short()) as sp:
        if not _on_card(buckets.values):
            out = kref.mttkrp_bucketed_ref(buckets.values, buckets.indices,
                                           buckets.local_row, factors,
                                           buckets.mode, buckets.block_rows,
                                           _plain_acc(t, dt))
            return sp.fence(out[:num_rows].to(dt))
        _refuse_grad("MTTKRP", buckets.values, *factors)
        if buckets.values.dtype != dt:
            buckets = dataclasses.replace(buckets,
                                          values=buckets.values.to(dt))
        return sp.fence(kmttkrp.mttkrp_cuda(
            buckets, [_cast(f, dt) for f in factors], t)[:num_rows])


def cg_matvec_bucketed(buckets, factors: Sequence[Optional[torch.Tensor]],
                       x: torch.Tensor, num_rows: Optional[int] = None,
                       tile: Optional[ktile.KernelTile] = None
                       ) -> torch.Tensor:
    """Implicit-CG Gram matvec (paper eq. 3) over the Ω buckets (their
    values are the weights ω), in the promoted type of x and the factors
    (the reference's rule, which leaves ω out; on the card ω joins the
    promotion of the operands the kernel takes), routed by rank on both
    devices:

    - R ≤ ``kernels.mttkrp.MAX_RANK``: one fused pass (the fused CG-matvec
      kernel on the card);
    - wider R: TTTP over the same bucket view, ``z = ω·⟨KR, x_i⟩``
      (:func:`tttp_bucket_values`), then the bucketed MTTKRP with values z,
      one launch per column tile on the card, each in its own family's
      current tile with this call's accumulator (z is rounded to the
      operands' type between the two). The fused kernel keeps a Khatri-Rao
      row and x's rows resident, which it cannot at that width."""
    num_rows = num_rows or buckets.shape[buckets.mode]
    mode = buckets.mode
    t = _resolve_tile("cg_matvec", tile)
    if x.shape[1] > kmttkrp.MAX_RANK:
        def halves(family):
            return dataclasses.replace(ktile.current_tile(family),
                                       accum_dtype=t.accum_dtype)
        fs = list(factors)
        fs[mode] = x
        z = tttp_bucket_values(buckets, fs, halves("tttp"))
        fs[mode] = None
        return mttkrp_bucketed(dataclasses.replace(buckets, values=z), fs,
                               num_rows, halves("mttkrp"))
    dt = _out_dtype(x, factors)
    with obs.span("kernel/cg_matvec_bucketed", mode=mode, rows=num_rows,
                  tile=t.short()) as sp:
        if not _on_card(buckets.values):
            out = kref.cg_matvec_bucketed_ref(buckets.values,
                                              buckets.indices,
                                              buckets.local_row, factors, x,
                                              mode, buckets.block_rows,
                                              _plain_acc(t, dt))
            return sp.fence(out[:num_rows].to(dt))
        _refuse_grad("fused CG-matvec", buckets.values, x, *factors)
        kdt = _promoted(buckets.values, x, *factors)
        if buckets.values.dtype != kdt:
            buckets = dataclasses.replace(buckets,
                                          values=buckets.values.to(kdt))
        out = kcg.cg_matvec_cuda(buckets, [_cast(f, kdt) for f in factors],
                                 _cast(x, kdt), t)
        return sp.fence(out[:num_rows].to(dt))


BUCKET_MATVEC_PATHS = ("fused", "tttp_mttkrp", "sliced")


def column_slices(fs: Sequence[Optional[torch.Tensor]], h: int):
    """``fs`` cut into ``h`` column slices of ⌈R/h⌉ (the last may be
    narrower), each contiguous; ``h`` = 1 gives ``fs`` itself."""
    if h <= 1:
        return [list(fs)]
    r = next(f.shape[1] for f in fs if f is not None)
    rs = -(-r // h)
    return [[None if f is None else f[:, c0:c0 + rs].contiguous()
             for f in fs] for c0 in range(0, r, rs)]


def bucket_matvec(buckets, factors: Sequence[Optional[torch.Tensor]],
                  x: torch.Tensor, path: str = "fused", h_slices: int = 1,
                  x_factors: Optional[Sequence] = None,
                  x_slices: Optional[int] = None,
                  mttkrp: Optional[Callable] = None,
                  psum_model: Optional[Callable] = None) -> torch.Tensor:
    """G_ω x (paper eq. 3, without the λ term) over a bucket view of Ω along
    ``buckets.mode``: nothing is gathered through the bucket pattern per
    call. The schedules of the solvers' and the planner's Gram matvec:

    * ``fused`` (``h_slices`` 1): :func:`cg_matvec_bucketed`;
    * otherwise the two halves: the TTTP kernel over the view,
      z_n = ω_n Σ_s Π a_ds · x_is in bucket order, then an MTTKRP of the
      view with values z. ``h_slices`` > 1 is the paper's H-sliced
      schedule (the TTTP halves of ⌈R/H⌉-column slices summed into z, then
      one MTTKRP per column slice, joined); ``sliced`` is this schedule
      by name.

    ``x_factors`` gives the TTTP half factors of its own (an einsum whose
    two rank halves read different matrices), cut into ``x_slices``
    (default ``h_slices``). ``mttkrp(zb, fs)`` runs the MTTKRP half on the
    view ``zb`` and one column slice ``fs`` of the factors (default
    :func:`mttkrp_bucketed`, the MTTKRP kernel). ``psum_model`` sums z
    over a model axis between the halves (factor columns sliced over it):
    the fused pass has no place for it, so with it the halves run apart."""
    if path not in BUCKET_MATVEC_PATHS:
        raise ValueError(f"matvec path {path!r} not in {BUCKET_MATVEC_PATHS}")
    mode = buckets.mode
    num_rows = buckets.shape[mode]
    if (path == "fused" and h_slices == 1 and x_factors is None
            and mttkrp is None and psum_model is None):
        return cg_matvec_bucketed(buckets, factors, x, num_rows=num_rows)
    fs = list(factors if x_factors is None else x_factors)
    fs[mode] = x
    z = None
    for sl in column_slices(fs, x_slices or h_slices):
        part = tttp_bucket_values(buckets, sl)
        z = part if z is None else z + part
    if psum_model is not None:
        z = psum_model(z)
    zb = dataclasses.replace(buckets, values=z)
    if mttkrp is None:
        def mttkrp(view, sl):
            return mttkrp_bucketed(view, sl, num_rows=num_rows)
    fs = list(factors)
    fs[mode] = None
    cols = [mttkrp(zb, sl) for sl in column_slices(fs, h_slices)]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
