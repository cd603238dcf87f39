"""Bucketed MTTKRP on the card: the wrapper of ``csrc/mttkrp.cu``, which
replaces the reference's ``kernels/mttkrp.py:mttkrp_pallas``.

One CTA per CCSR bucket accumulates the bucket's ``block_rows`` output rows
in shared memory (``csrc/scatter_rows.cuh``). ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.sparse.ccsr import RowBlockBuckets

# dynamic shared memory one CTA may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

launches = 0


def check_buckets(buckets: RowBlockBuckets, r: int) -> torch.device:
    """Validate the bucket arrays and the (block_rows, R) shared-memory
    accumulator for a launch; returns their device."""
    dev = buckets.values.device
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    if nd > 8:
        raise ValueError(f"order {nd} > 8: the kernels take at most 8 modes")
    _build.check_operand("bucket values", buckets.values, torch.float32, dev)
    _build.check_operand("bucket indices", buckets.indices, torch.int32, dev,
                         (nb, c, nd))
    _build.check_operand("bucket local_row", buckets.local_row, torch.int32,
                         dev, (nb, c))
    _build.check_operand("bucket valid", buckets.valid, torch.bool, dev,
                         (nb, c))
    smem = 4 * buckets.block_rows * r
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_rows·R·4 = {smem} B exceeds the "
                         f"{MAX_SMEM_BYTES} B of shared memory a CTA may use")
    return dev


def mttkrp_cuda(buckets: RowBlockBuckets,
                factors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """Bucketed MTTKRP; factors at ``buckets.mode`` and None factors are
    skipped. Returns (nb·block_rows, R) float32; callers slice to
    ``shape[mode]`` rows."""
    global launches
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    mode = buckets.mode
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    other = [f for d, f in enumerate(factors) if d != mode and f is not None]
    if not other:
        raise ValueError("MTTKRP requires at least one non-target factor")
    r = other[0].shape[1]
    dev = check_buckets(buckets, r)
    table = [None if d == mode else f for d, f in enumerate(factors)]
    _build.check_factors(table, r, torch.float32, dev)
    out = torch.empty(nb * buckets.block_rows, r, dtype=torch.float32,
                      device=dev)
    if nb == 0:
        return out
    ptrs = _build.pointer_table(table)
    with torch.cuda.device(dev):
        _build.launch("repro_mttkrp_bucketed_f32", buckets.values.data_ptr(),
                      buckets.indices.data_ptr(),
                      buckets.local_row.data_ptr(), buckets.valid.data_ptr(),
                      nb, c, nd, mode, ptrs, r, buckets.block_rows,
                      out.data_ptr(), _build.THREADS,
                      torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
