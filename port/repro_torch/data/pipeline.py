"""Single-device ingest of a completion dataset.

``CompletionDataset`` builds the CCSR bucket pattern of every mode once
(the Ω pattern does not change across sweeps) and derives ``omega``, the
Ω indicator, through ``with_values`` so that it shares those patterns with
the data tensor. An in-memory tensor is shuffled first; a streamed one
(:meth:`CompletionDataset.from_stream`) is not, and takes its bucket
capacities from the occupancy counts streamed at ingest.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import synthetic
from repro_torch.planner.config import default_config
from repro_torch.sparse.ccsr import IncrementalBucketBuilder, bucket_pattern


class CompletionDataset:

    def __init__(self, st: SparseTensor, generator: torch.Generator,
                 block_rows: Optional[int] = None):
        """``block_rows`` defaults to the planner config's, so ingest and
        planner dispatch read one bucket view."""
        block_rows = block_rows or default_config().block_rows
        tensor = synthetic.shuffle_and_pad(st, generator, num_shards=1)
        self._finish(tensor, block_rows, num_shards=1, stats=None)

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
        the held-out tensor (None when ``test_fraction`` is 0)."""
        from repro_torch.data import streaming
        if mesh is not None:
            raise ValueError("mesh: the port runs on one device so far")
        block_rows = block_rows or default_config().block_rows
        train, test, stats = streaming.ingest(
            chunks, shape, num_shards=num_shards or 1, spool_dir=spool_dir,
            test_fraction=test_fraction, block_rows=block_rows,
            device=device)
        ds = cls.__new__(cls)
        ds._finish(train, block_rows, num_shards=num_shards or 1,
                   stats=stats)
        ds.test = test
        return ds

    def _finish(self, tensor: SparseTensor, block_rows: int,
                num_shards: int, stats) -> None:
        self.stats = stats
        self.test = None
        self.num_shards = num_shards
        self.block_rows = block_rows
        counts = getattr(stats, "bucket_counts", None)
        # streamed counts give the capacity with no extra counting pass
        builder = (IncrementalBucketBuilder(tensor.shape, block_rows, counts)
                   if counts is not None
                   and stats.bucket_block_rows == block_rows else None)
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
        out, so two ingests of one logical tensor compare bit for bit."""
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
