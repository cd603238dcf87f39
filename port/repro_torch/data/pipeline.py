"""Ingest of a completion dataset, on one device or onto a rank layout.

``CompletionDataset`` builds the CCSR bucket pattern of every mode once
(the Ω pattern does not change across sweeps) and derives ``omega``, the
Ω indicator, through ``with_values`` so that it shares those patterns with
the data tensor. An in-memory tensor is shuffled first; a streamed one
(:meth:`CompletionDataset.from_stream`) is not, and takes its bucket
capacities from the occupancy counts streamed at ingest.

With ``mesh=`` (a ``core.distributed.DistLayout``) the tensor is padded to
a multiple of the data-axis size and each rank keeps its block of the
nonzero slots (``tensor``), with bucket views over its own nonzeros only.
Every rank ingests the same logical tensor (the same seed or stream), so
the blocks partition it.

For language-model batches :func:`lm_batches` wraps
``synthetic.token_stream`` in :func:`prefetch`; under an ``AxisCtx`` each
rank keeps its block of every batch's rows over the batch axes (the
reference places the batch on a ``NamedSharding`` over them).
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import synthetic
from repro_torch.planner.config import default_config
from repro_torch.sparse.ccsr import IncrementalBucketBuilder, bucket_pattern


class CompletionDataset:

    def __init__(self, st: SparseTensor, generator: torch.Generator,
                 block_rows: Optional[int] = None, mesh=None):
        """``block_rows`` defaults to the planner config's, so ingest and
        planner dispatch read one bucket view. ``mesh`` (a ``DistLayout``)
        shards the nonzeros over its data axes."""
        block_rows = block_rows or default_config().block_rows
        num_shards = 1 if mesh is None else mesh.data_size
        tensor = synthetic.shuffle_and_pad(st, generator,
                                           num_shards=num_shards)
        self._finish(tensor, block_rows, num_shards=num_shards, stats=None,
                     mesh=mesh)

    @classmethod
    def from_stream(cls, chunks, shape, num_shards: Optional[int] = None,
                    mesh=None, block_rows: Optional[int] = None,
                    spool_dir: Optional[str] = None,
                    test_fraction: float = 0.0,
                    device="cuda") -> "CompletionDataset":
        """Ingest a chunk stream (``repro_torch.data.streaming``) without
        ever holding the raw COO tensor: chunk-wise dedup, hash-sharding
        and a per-shard sort-merge into the canonical shard-block layout on
        ``device``, with every mode's bucket pattern built at the capacity
        the streamed occupancy counts give. No shuffle: the coordinate hash
        balances the shards, and the layout is deterministic (the same
        stream gives the same entries for any shard count). ``test`` holds
        the held-out tensor (None when ``test_fraction`` is 0; whole on every
        rank under ``mesh``).

        ``mesh`` (a ``DistLayout``): ``num_shards`` defaults to its
        data-axis size and must be a multiple of it (each rank keeps
        ``num_shards / data_size`` consecutive shard blocks, a contiguous
        run of slots); otherwise ValueError."""
        from repro_torch.data import streaming
        data_size = 1 if mesh is None else mesh.data_size
        num_shards = num_shards or data_size
        if num_shards % data_size:
            raise ValueError(f"num_shards={num_shards} is not a multiple of "
                             f"the mesh's data-axis size {data_size}")
        block_rows = block_rows or default_config().block_rows
        train, test, stats = streaming.ingest(
            chunks, shape, num_shards=num_shards, spool_dir=spool_dir,
            test_fraction=test_fraction, block_rows=block_rows,
            device=device)
        ds = cls.__new__(cls)
        ds._finish(train, block_rows, num_shards=num_shards, stats=stats,
                   mesh=mesh)
        ds.test = test
        return ds

    def _finish(self, tensor: SparseTensor, block_rows: int,
                num_shards: int, stats, mesh=None) -> None:
        self.stats = stats
        self.test = None
        self.num_shards = num_shards
        self.block_rows = block_rows
        self.mesh = mesh
        self.global_nnz = tensor.nnz
        if mesh is not None:
            tensor = mesh.shard(tensor)
        counts = getattr(stats, "bucket_counts", None)
        # streamed counts give the capacity with no extra counting pass; they
        # count the whole stream, so a rank holding one shard of several
        # counts its own
        builder = (IncrementalBucketBuilder(tensor.shape, block_rows, counts)
                   if counts is not None
                   and stats.bucket_block_rows == block_rows
                   and (mesh is None or mesh.data_size == 1) else None)
        for mode in range(tensor.ndim):
            tensor.attach_pattern(
                mode, block_rows,
                builder.build(tensor, mode) if builder is not None
                else bucket_pattern(tensor, mode, block_rows))
        self.tensor = tensor
        self.omega = tensor.with_values(torch.ones_like(tensor.values))

    def gather_global(self):
        """Host-side canonical view of the valid entries: (indices, values)
        sorted by linearized coordinate. Shard layout and padding cancel
        out, so two ingests of one logical tensor compare bit for bit.
        Under a mesh: this rank's block only."""
        idx = self.tensor.indices.cpu().numpy()
        vals = self.tensor.values.cpu().numpy()
        valid = self.tensor.valid.cpu().numpy()
        idx, vals = idx[valid], vals[valid]
        lin = np.zeros(idx.shape[0], np.int64)
        for d, s in enumerate(self.tensor.shape):
            lin = lin * np.int64(s) + idx[:, d].astype(np.int64)
        order = np.argsort(lin, kind="stable")
        return idx[order], vals[order]


def prefetch(it: Iterator) -> Iterator:
    """Yield the items of ``it``, made on a background thread one ahead of
    the one the caller holds (overlaps making the next item with the
    caller's work, and holds one extra item in memory, not the stream). An
    exception raised by ``it`` is raised here, at the item it failed on."""
    it = iter(it)
    made: queue.Queue = queue.Queue()
    room = threading.Semaphore(1)

    def worker():
        try:
            while True:
                room.acquire()
                try:
                    item = next(it)
                except StopIteration:
                    made.put((False, None))
                    return
                made.put((True, item))
        except BaseException as e:  # handed to the consumer, raised there
            made.put((False, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        ok, item = made.get()
        if not ok:
            if item is not None:
                raise item
            return
        room.release()
        yield item


def lm_batches(generator: Optional[torch.Generator], vocab_size: int,
               batch: int, seq_len: int, num_batches: int, ctx=None,
               batch_axes: Sequence[str] = ("data",),
               device: str = "cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Token batches for an LM driver, made one ahead by :func:`prefetch`
    (``synthetic.token_stream``). With ``ctx`` (a
    ``core.distributed.AxisCtx``) each rank yields its block of every
    batch's rows: the rows split into as many blocks as the batch axes'
    sizes multiply to, this rank's block at its coordinates over those
    axes flattened row-major (the reference's batch dimension sharded
    over ``batch_axes``); ``batch`` must divide evenly."""
    stream = synthetic.token_stream(generator, vocab_size, batch, seq_len,
                                    num_batches, device=device)
    if ctx is None:
        yield from prefetch(stream)
        return
    sizes, coords = dict(ctx.sizes), dict(ctx.coords)
    missing = [a for a in batch_axes if a not in sizes or a not in coords]
    if missing:
        raise ValueError(f"batch axes {missing} are not axes of {ctx!r}")
    shards = math.prod(sizes[a] for a in batch_axes)
    if batch % shards:
        raise ValueError(f"batch {batch} does not split over {shards} "
                         f"shards of {tuple(batch_axes)}")
    index = 0
    for a in batch_axes:
        index = index * sizes[a] + coords[a]
    rows = batch // shards
    for b in prefetch(stream):
        yield {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}
