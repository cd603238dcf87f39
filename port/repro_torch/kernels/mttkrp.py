"""Bucketed MTTKRP on the card: the wrapper of ``csrc/mttkrp.cu``, which
replaces the reference's ``kernels/mttkrp.py:mttkrp_pallas``, and what it
shares with the fused CG matvec (``kernels/cg_matvec.py``).

Both run one kernel body (``csrc/bucket_rows.cuh``): one CTA per CCSR
bucket, which sums the bucket's ``block_rows`` output rows in shared memory
from per-thread running sums (``csrc/scatter_rows.cuh``). The kernel
gathers factor rows as 16-byte loads, so :func:`launch_bucketed` hands it
copies of the factors padded with zero columns to a row stride of a
multiple of 4 floats (:func:`pad_rows`); the zero columns add exact zeros.
``launches`` counts the MTTKRP kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.utils import round_up
from repro_torch.kernels import _build
from repro_torch.sparse.ccsr import RowBlockBuckets

# dynamic shared memory one CTA may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
# the kernels keep a Khatri-Rao row and a running sum in registers, compiled
# for padded widths up to this
MAX_RANK = 128
# floats per 16-byte vector load of a padded row
ROW_ALIGN = 4

launches = 0


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, R) as rows of ``round_up(R, 4)`` floats: a contiguous
    copy whose columns past R are zero, at a 16-byte-aligned address, so
    every row starts on a 16-byte boundary. ``t`` itself when it already is
    one."""
    r = t.shape[1]
    width = round_up(r, ROW_ALIGN)
    if width == r and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, width - r)).contiguous()


def check_buckets(buckets: RowBlockBuckets, r: int,
                  fused: bool) -> torch.device:
    """Validate the bucket arrays and the shared-memory rows (the
    (block_rows, padded R) sums, and as many rows of x when ``fused``) for
    a launch; returns their device."""
    dev = buckets.values.device
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    if nd > 8:
        raise ValueError(f"order {nd} > 8: the kernels take at most 8 modes")
    if r > MAX_RANK:
        raise ValueError(f"R={r} > {MAX_RANK}: the bucketed kernels keep a "
                         f"Khatri-Rao row in registers up to R={MAX_RANK}")
    _build.check_operand("bucket values", buckets.values, torch.float32, dev)
    _build.check_operand("bucket indices", buckets.indices, torch.int32, dev,
                         (nb, c, nd))
    _build.check_operand("bucket local_row", buckets.local_row, torch.int32,
                         dev, (nb, c))
    _build.check_operand("bucket valid", buckets.valid, torch.bool, dev,
                         (nb, c))
    smem = 4 * buckets.block_rows * round_up(r, ROW_ALIGN) * (2 if fused
                                                              else 1)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} B of shared-memory rows exceed the "
                         f"{MAX_SMEM_BYTES} B a CTA may use")
    return dev


def launch_bucketed(name: str, buckets: RowBlockBuckets,
                    factors: Sequence[Optional[torch.Tensor]],
                    x: Optional[torch.Tensor], r: int) -> torch.Tensor:
    """Launch the bucketed kernel ``name`` (the fused matvec when ``x`` is
    given) after checking its operands; factors at ``buckets.mode`` and None
    factors are skipped. Returns (nb·block_rows, R) float32."""
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    mode = buckets.mode
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    dev = check_buckets(buckets, r, x is not None)
    table = [None if d == mode else f for d, f in enumerate(factors)]
    _build.check_factors(table, r, torch.float32, dev)
    if x is not None:
        _build.check_operand("x", x, torch.float32, dev, (x.shape[0], r))
    out = torch.empty(nb * buckets.block_rows, r, dtype=torch.float32,
                      device=dev)
    if nb == 0:
        return out
    padded = [None if f is None else pad_rows(f) for f in table]
    xp = None if x is None else pad_rows(x)
    ptrs = _build.pointer_table(padded)
    with torch.cuda.device(dev):
        _build.launch(name, buckets.values.data_ptr(),
                      buckets.indices.data_ptr(),
                      buckets.local_row.data_ptr(), buckets.valid.data_ptr(),
                      nb, c, nd, mode, ptrs,
                      None if xp is None else xp.data_ptr(),
                      0 if xp is None else xp.shape[0], r,
                      round_up(r, ROW_ALIGN), buckets.block_rows,
                      out.data_ptr(), _build.THREADS,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out


def mttkrp_cuda(buckets: RowBlockBuckets,
                factors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """Bucketed MTTKRP; factors at ``buckets.mode`` and None factors are
    skipped. Returns (nb·block_rows, R) float32; callers slice to
    ``shape[mode]`` rows."""
    global launches
    other = [f for d, f in enumerate(factors)
             if d != buckets.mode and f is not None]
    if not other:
        raise ValueError("MTTKRP requires at least one non-target factor")
    out = launch_bucketed("repro_mttkrp_bucketed_f32", buckets, factors,
                          None, other[0].shape[1])
    if buckets.num_blocks:
        launches += 1
    return out
