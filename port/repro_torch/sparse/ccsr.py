"""CCSR views of one mode of a sparse tensor: the paper's doubly compressed
row view and the row-block buckets the kernels take.

``CCSRView`` (``build_ccsr``) is CSR over the nonzero rows only, with a map
from compressed to original rows: Θ(m) storage for m nonzeros, never
Θ(rows). ``RowBlockBuckets`` groups the nonzeros, sorted by the bucketed
mode, into fixed-capacity buckets of ``block_rows`` consecutive output
rows. The bucketed MTTKRP and fused CG-matvec kernels give each bucket to
one CTA, which owns those output rows and so needs no global atomics.

The pattern (``sel``, ``indices``, ``local_row``, ``valid``) depends only on
Ω and is built once at ingest; a tensor's bucket values are gathered through
``sel`` (``BucketPattern.gather``) once per tensor and mode, and kept by
``SparseTensor.row_buckets`` while the tensor's values stay the same. The
build is written in torch so it runs on the tensor's own device (a stable
sort on the card for paper-scale tensors); it yields the same arrays, bit
for bit, as the reference's host-side numpy build.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import cdiv, round_up


@dataclasses.dataclass
class CCSRView:
    """Doubly compressed view over a mode of a sorted SparseTensor.

    ``row_ids[c]`` is the original row of compressed row ``c`` (padded with
    ``num_rows``); the entries of compressed row ``c`` occupy the slice
    ``row_ptr[c]:row_ptr[c+1]`` of the sorted COO arrays."""

    row_ids: torch.Tensor   # (rows_cap,) int32, padded with num_rows
    row_ptr: torch.Tensor   # (rows_cap + 1,) int32
    num_rows: int           # original (uncompressed) number of rows
    nnz_rows: torch.Tensor  # () int32: the number of nonzero rows

    @property
    def rows_cap(self) -> int:
        return self.row_ids.shape[0]


def build_ccsr(st: SparseTensor, mode: int,
               rows_cap: Optional[int] = None) -> CCSRView:
    """CCSR view of ``mode``; ``st`` must be sorted by that mode.
    ``rows_cap`` defaults to ``min(cap, num_rows)``, the hypersparse Θ(m)
    bound; compressed rows past it are dropped. No host synchronisation."""
    if st.sorted_mode != mode:
        raise ValueError(f"SparseTensor must be sorted by mode {mode} "
                         f"(got sorted_mode={st.sorted_mode})")
    num_rows = st.shape[mode]
    if rows_cap is None:
        rows_cap = min(st.cap, num_rows)
    dev = st.indices.device
    rows = torch.where(st.mask, st.indices[:, mode], num_rows)
    prev = torch.cat([torch.full((1,), -1, dtype=rows.dtype, device=dev),
                      rows[:-1]])
    is_start = (rows != prev) & st.mask
    crow = torch.cumsum(is_start, 0) - 1       # compressed row of each entry
    nnz_rows = is_start.sum().to(torch.int32)
    # the starting rows land in their compressed slots; everything else (and
    # a start past rows_cap) in one spare slot that is cut off
    slot = torch.where(is_start, torch.clamp(crow, max=rows_cap), rows_cap)
    row_ids = torch.full((rows_cap + 1,), num_rows, dtype=torch.int32,
                         device=dev)
    row_ids.scatter_(0, slot, rows.to(torch.int32))
    seg = torch.where(st.mask, torch.clamp(crow, max=rows_cap + 1),
                      rows_cap + 1)
    counts = torch.zeros(rows_cap + 2, dtype=torch.int32, device=dev)
    counts.index_add_(0, seg, st.mask.to(torch.int32))
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts[:rows_cap], 0).to(torch.int32)])
    return CCSRView(row_ids[:rows_cap], row_ptr, num_rows, nnz_rows)


@dataclasses.dataclass
class RowBlockBuckets:
    """Bucket ``b`` holds the entries with ``row // block_rows == b``, padded
    to ``capacity`` with value-0, ``valid=False`` slots whose ``local_row``
    is 0."""

    values: torch.Tensor     # (nb, capacity)
    indices: torch.Tensor    # (nb, capacity, ndim) int32, global indices
    local_row: torch.Tensor  # (nb, capacity) int32 in [0, block_rows)
    valid: torch.Tensor      # (nb, capacity) bool
    mode: int
    block_rows: int
    shape: Tuple[int, ...]

    @property
    def num_blocks(self) -> int:
        return self.values.shape[0]

    @property
    def capacity(self) -> int:
        return self.values.shape[1]


@dataclasses.dataclass
class BucketPattern:
    """Ingest-time bucket layout over one mode of a fixed Ω pattern; ``sel``
    maps each bucket slot back to its source COO slot (padding → 0)."""

    sel: torch.Tensor        # (nb, capacity) int32
    indices: torch.Tensor    # (nb, capacity, ndim) int32
    local_row: torch.Tensor  # (nb, capacity) int32
    valid: torch.Tensor      # (nb, capacity) bool
    mode: int
    block_rows: int
    shape: Tuple[int, ...]
    cap: int                 # source capacity the pattern was built against

    def gather(self, st: SparseTensor) -> RowBlockBuckets:
        """Bucket view of ``st``'s values through this pattern; ``st`` must
        share the Ω pattern the pattern was built from."""
        if st.cap != self.cap or st.shape != self.shape:
            raise ValueError(f"pattern built for cap={self.cap} shape="
                             f"{self.shape}, got cap={st.cap} shape={st.shape}")
        vals = torch.where(self.valid, st.masked_values()[self.sel], 0)
        return RowBlockBuckets(vals, self.indices, self.local_row, self.valid,
                               self.mode, self.block_rows, self.shape)


def bucket_pattern(st: SparseTensor, mode: int, block_rows: int,
                   capacity: Optional[int] = None,
                   capacity_multiple: int = 8) -> BucketPattern:
    """Bucket-pattern build, once per (Ω pattern, mode, block_rows).

    Capacity defaults to the largest bucket's occupancy rounded up to
    ``capacity_multiple``: with shuffled uniform data that is mean +
    O(√mean); under heavy skew every bucket pays for the largest one."""
    dev = st.indices.device
    orig = torch.nonzero(st.valid).squeeze(1)
    idx = st.indices[orig]
    nnz, nd = idx.shape
    rows = idx[:, mode].long()
    if st.sorted_mode != mode:
        order = torch.sort(rows, stable=True).indices
        idx, rows, orig = idx[order], rows[order], orig[order]
    # else: entries already non-decreasing in this mode — the stable sort
    # would be the identity
    nb = cdiv(st.shape[mode], block_rows)
    bucket = rows // block_rows
    counts = torch.bincount(bucket, minlength=nb)
    # the fullest bucket sizes the pattern's arrays on the host; patterns are
    # built at ingest (SGD: once per sampled sweep)
    # repro-lint: disable=JS002 -- a pattern's capacity is a host int
    most = int(counts.max()) if nnz else 0
    if capacity is None:
        capacity = round_up(max(most, 1), capacity_multiple)
    elif most > capacity:
        raise ValueError(f"bucket overflow: max occupancy {most} > "
                         f"capacity {capacity}; increase capacity")
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nnz, device=dev) - starts[bucket]
    slot = bucket * capacity + pos
    bsel = torch.zeros(nb * capacity, dtype=torch.int32, device=dev)
    bidx = torch.zeros(nb * capacity, nd, dtype=torch.int32, device=dev)
    blocal = torch.zeros(nb * capacity, dtype=torch.int32, device=dev)
    bvalid = torch.zeros(nb * capacity, dtype=torch.bool, device=dev)
    bsel[slot] = orig.to(torch.int32)
    bidx[slot] = idx
    blocal[slot] = (rows - bucket * block_rows).to(torch.int32)
    bvalid[slot] = True
    return BucketPattern(bsel.view(nb, capacity),
                         bidx.view(nb, capacity, nd),
                         blocal.view(nb, capacity),
                         bvalid.view(nb, capacity),
                         mode, block_rows, st.shape, st.cap)


def bucket_capacity(counts, capacity_multiple: int = 8) -> int:
    """Bucket capacity from an occupancy-count array."""
    counts = torch.as_tensor(counts)
    # repro-lint: disable=JS002 -- a pattern's capacity, from ingest's counts
    most = int(counts.max()) if counts.numel() else 1
    return round_up(max(most, 1), capacity_multiple)


class IncrementalBucketBuilder:
    """Bucket occupancy counted at ingest, chunk by chunk.

    The streamed ingest (``repro_torch.data.streaming``) cannot afford a
    whole-tensor counting pass per mode once its runs are spilled, so this
    builder ``observe``s each deduplicated chunk's indices on the host and
    keeps int64 counts per mode in O(Σ I_d / block_rows) memory. ``build``
    hands :func:`bucket_pattern` the capacity those counts give. Duplicates
    across chunks, dropped later at the shard merge, can only make the
    counts too high: the capacity is a safe, slightly padded bound.
    ``counts`` resumes from counts streamed earlier (``IngestStats``)."""

    def __init__(self, shape, block_rows: int, counts=None):
        self.shape = tuple(int(s) for s in shape)
        self.block_rows = int(block_rows)
        self.counts = ([np.zeros(cdiv(s, block_rows), np.int64)
                        for s in self.shape] if counts is None
                       else [np.asarray(c, np.int64) for c in counts])

    def observe(self, indices: np.ndarray) -> None:
        """Add one chunk's (n, ndim) indices to the counts."""
        for d in range(len(self.shape)):
            b = indices[:, d] // self.block_rows
            self.counts[d] += np.bincount(
                b, minlength=self.counts[d].shape[0]).astype(np.int64)

    def capacity(self, mode: int, capacity_multiple: int = 8) -> int:
        return bucket_capacity(self.counts[mode], capacity_multiple)

    def build(self, st: SparseTensor, mode: int) -> BucketPattern:
        """Pattern of ``st`` (the finalized tensor over the observed Ω) with
        the streamed capacity."""
        return bucket_pattern(st, mode, self.block_rows,
                              capacity=self.capacity(mode))


def bucketize(st: SparseTensor, mode: int, block_rows: int,
              capacity: Optional[int] = None,
              capacity_multiple: int = 8) -> RowBlockBuckets:
    """One-shot bucket view: pattern build and value gather (see
    :func:`bucket_pattern`; ``SparseTensor.row_buckets`` caches the pattern
    across value updates)."""
    return bucket_pattern(st, mode, block_rows, capacity,
                          capacity_multiple).gather(st)
