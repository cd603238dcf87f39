"""Bucketed MTTKRP on the card: the wrapper of ``csrc/mttkrp.cu``, which
replaces the reference's ``kernels/mttkrp.py:mttkrp_pallas``, and what it
shares with the fused CG matvec (``kernels/cg_matvec.py``).

Both run one kernel body (``csrc/bucket_rows.cuh``): one CTA per CCSR
bucket, which sums the bucket's ``block_rows`` output rows from per-thread
running sums into one shared slab per warp and adds the slabs in warp
order, so two launches on the same inputs give the same bits
(``csrc/scatter_rows.cuh``). The body is instantiated for float32,
bfloat16 and float64 operands: a bf16 launch reads bf16 values, factor
rows and x, accumulates in float32 and writes bf16; a float64 launch
reads, accumulates and writes float64; and a tile with
``accum_dtype="float64"`` sums float32 or bf16 operands in float64 and
writes their type (``csrc/*_acc64.cu``). The kernel
gathers factor rows as 16-byte loads, so the wrappers hand it copies of the
factors padded with zero columns to a row stride of 16 bytes, 4 floats, 8
bf16 values or 2 doubles (:func:`pad_rows`); the zero columns add exact
zeros. One launch covers at
most ``MAX_RANK`` columns, since the body keeps a Khatri-Rao row and a
running sum in registers: the MTTKRP takes any R as one launch per column
tile (:func:`column_tiles`), each over a padded copy of the tile's columns,
and joins the tiles' outputs. (Passing a tile as a pointer into the full
padded rows would need a row stride apart from the width the body computes,
and separating the two changed how nvcc compiled the body for R ≤ 128.)
The launch shape (threads per CTA, slots per thread) is a
``kernels.tile.KernelTile``, and so is the accumulator. ``launches``
counts the MTTKRP kernel's launches, ``launches_by_dtype`` splits them by
element type and accumulator, and ``last_launch`` holds the (threads,
per_thread) of the last one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.utils import round_up
from repro_torch.kernels import _build
from repro_torch.kernels.tile import DEFAULT_TILE, KernelTile
from repro_torch.sparse.ccsr import RowBlockBuckets

# the widest padded row one launch of the bucketed body takes: it keeps a
# Khatri-Rao row and a running sum in registers, compiled for widths up to
# this
MAX_RANK = 128
# bytes of one vector load of a padded row
ROW_BYTES = 16

launches = 0
launches_by_dtype = dict.fromkeys(_build.VARIANT_NAMES, 0)
last_launch = None


def padded_width(r: int, dtype: torch.dtype) -> int:
    """RS, the row stride in elements the kernels take for R columns: R
    rounded up to one 16-byte vector load (4 float32, 8 bfloat16, 2
    float64)."""
    return round_up(r, ROW_BYTES // dtype.itemsize)


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, R) as rows of :func:`padded_width` elements (16 bytes a
    vector: R rounded up to 4 floats, 8 bf16 values or 2 doubles): a
    contiguous copy whose columns past R are zero, at a 16-byte-aligned
    address, so every row starts on a 16-byte boundary. ``t`` itself when
    it already is one."""
    r = t.shape[1]
    width = padded_width(r, t.dtype)
    if width == r and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, width - r)).contiguous()


def column_tiles(r: int) -> List[Tuple[int, int]]:
    """``(first column, width)`` of the launches that cover R columns: tiles
    of ``MAX_RANK`` columns from column 0 and the rest, so every tile starts
    at a multiple of 16 bytes of a padded row in every element type. One
    tile, (0, R), for R ≤ ``MAX_RANK``."""
    return [(c0, min(MAX_RANK, r - c0)) for c0 in range(0, r, MAX_RANK)]


def check_buckets(buckets: RowBlockBuckets, factors, r: int,
                  x: Optional[torch.Tensor],
                  tile: KernelTile) -> List[Optional[torch.Tensor]]:
    """Check the bucket arrays, the factors and ``x`` (given for the fused
    matvec) for launches over ``r`` columns in ``tile``, all of one element
    type (float32, bfloat16 or float64), and the shared memory of the
    widest launch (``footprint.dynamic_smem_bytes``: one slab of
    (block_rows, padded width) sums in the accumulator type per warp, and
    the rows of x when fused). Returns the factor table the kernels take:
    None at ``buckets.mode`` and for absent factors."""
    dev = buckets.values.device
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    if nd > 8:
        raise ValueError(f"order {nd} > 8: the kernels take at most 8 modes")
    if x is not None and r > MAX_RANK:
        raise ValueError(f"R={r} > {MAX_RANK}: the fused kernel keeps a "
                         f"Khatri-Rao row in registers up to R={MAX_RANK}; "
                         f"kernels.ops.cg_matvec_bucketed routes wider R "
                         f"through TTTP and the MTTKRP")
    table = [None if d == buckets.mode else f for d, f in enumerate(factors)]
    dt = _build.operand_dtype(
        values=buckets.values, x=x,
        **{f"factor {d}": f for d, f in enumerate(table)})
    _build.check_operand("bucket values", buckets.values, dt, dev)
    _build.check_operand("bucket indices", buckets.indices, torch.int32, dev,
                         (nb, c, nd))
    _build.check_operand("bucket local_row", buckets.local_row, torch.int32,
                         dev, (nb, c))
    _build.check_operand("bucket valid", buckets.valid, torch.bool, dev,
                         (nb, c))
    # here, not at the top: footprint imports this module's MAX_RANK
    from repro_torch.kernels import footprint
    smem = footprint.dynamic_smem_bytes(buckets.block_rows, r, x is not None,
                                        dt, tile.threads,
                                        tile.accumulator(dt))
    if smem > footprint.SMEM_PER_BLOCK_OPTIN:
        raise ValueError(f"{smem} B of shared-memory rows exceed the "
                         f"{footprint.SMEM_PER_BLOCK_OPTIN} B a CTA may use")
    _build.check_factors(table, r, dt, dev)
    if x is not None:
        _build.check_operand("x", x, dt, dev, (x.shape[0], r))
    return table


def launch_bucketed(name: str, buckets: RowBlockBuckets,
                    table: Sequence[Optional[torch.Tensor]],
                    x: Optional[torch.Tensor], r: int,
                    tile: KernelTile) -> torch.Tensor:
    """Launch the bucketed kernel ``name`` (``mttkrp_bucketed``, or
    ``cg_matvec_bucketed`` when ``x`` is given) once over the ``r`` ≤
    ``MAX_RANK`` columns of a factor table from :func:`check_buckets`, on
    zero-padded copies of the factors and x, in ``tile``'s launch shape, in
    the instantiation for the operands' element type and the tile's
    accumulator. Returns (nb·block_rows, r) in that type; launches nothing
    when there are no buckets."""
    nb, c = buckets.values.shape
    dev = buckets.values.device
    dt = buckets.values.dtype
    acc = tile.accumulator(dt)
    out = torch.empty(nb * buckets.block_rows, r, dtype=dt, device=dev)
    if nb == 0:
        return out
    padded = [None if f is None else pad_rows(f) for f in table]
    xp = None if x is None else pad_rows(x)
    with torch.cuda.device(dev):
        _build.launch(_build.entry(name, dt, acc), buckets.values.data_ptr(),
                      buckets.indices.data_ptr(),
                      buckets.local_row.data_ptr(), buckets.valid.data_ptr(),
                      nb, c, buckets.indices.shape[-1], buckets.mode,
                      _build.pointer_table(padded),
                      None if xp is None else xp.data_ptr(),
                      0 if xp is None else xp.shape[0], r,
                      padded_width(r, dt), buckets.block_rows,
                      out.data_ptr(), tile.threads, tile.per_thread,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out


def mttkrp_cuda(buckets: RowBlockBuckets,
                factors: Sequence[Optional[torch.Tensor]],
                tile: KernelTile = DEFAULT_TILE) -> torch.Tensor:
    """Bucketed MTTKRP; factors at ``buckets.mode`` and None factors are
    skipped. Values and factors share one element type, float32, bfloat16
    or float64. One launch per column tile (:func:`column_tiles`), the tiles'
    outputs joined by columns. Returns (nb·block_rows, R) in the operands'
    type; callers slice to ``shape[mode]`` rows."""
    global launches, last_launch
    other = [f for d, f in enumerate(factors)
             if d != buckets.mode and f is not None]
    if not other:
        raise ValueError("MTTKRP requires at least one non-target factor")
    r = other[0].shape[1]
    table = check_buckets(buckets, factors, r, None, tile)
    dt = buckets.values.dtype
    variant = _build.variant_name(dt, tile.accumulator(dt))
    outs = []
    for c0, w in column_tiles(r):
        # a column tile of all R columns is the factor itself (same storage)
        cols = [None if f is None else f[:, c0:c0 + w] for f in table]
        outs.append(launch_bucketed("mttkrp_bucketed", buckets, cols, None,
                                    w, tile))
        if buckets.num_blocks:
            launches += 1
            launches_by_dtype[variant] += 1
            last_launch = (tile.threads, tile.per_thread)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
