"""Streaming, memory-bounded (out-of-core) ingest for paper-scale tensors.

The paper's headline runs — 10B-nonzero synthetic tensors and the Netflix
data — cannot be *constructed* by an ingest path that materializes the whole
COO tensor at once. This module makes ingest a chunked pipeline whose peak
host memory is O(chunk), not O(nnz):

* **chunk generators** — deterministic synthetic streams (the Fig.-7a
  function tensor and the Zipf "netflix-like" ratings tensor) parameterized
  by target nnz with per-chunk RNG folding, plus a triplet-file reader for
  real Netflix-format data. Chunks are plain numpy (host) arrays.
* **StreamingIngest** — per chunk: in-chunk dedup/sort by linearized
  coordinate, deterministic hash-sharding over ``num_shards``, append to
  per-shard runs (in memory, or spilled to a spool directory for
  out-of-core operation). Finalize sort-merges each shard's runs into a
  canonical per-shard CCSR-friendly layout (sorted by linearized
  coordinate, first stream occurrence wins on duplicates) and builds the
  per-mode CCSR bucket patterns incrementally from streamed bucket counts
  (``repro_torch.sparse.ccsr.IncrementalBucketBuilder``).
* **IngestStats** — streamed metadata (exact nnz, per-mode nonzero-row
  counts, bucket occupancies): the planner's nnz hints come from here
  instead of from materialized arrays.
* **split + held-out evaluation** — a deterministic per-coordinate
  train/test split (duplicates of a coordinate always land on one side)
  and RMSE / Poisson-deviance evaluation on the held-out set.

The layout is *canonical*: ingesting the same stream with any shard count
yields the same global entry set bit-for-bit (per-shard entries are sorted
by linearized coordinate; shard membership is a pure hash of the
coordinate).

Everything up to :func:`pack_shards` is numpy on the host and seeds numpy
alone, so the same stream gives the same chunks, shards, stats and bucket
counts as the JAX package's ``repro.data.streaming``, bit for bit.
:func:`pack_shards` puts the result on a device (``cuda`` unless the caller
asks for the CPU), and :func:`heldout_metrics` scores through the TTTP
kernel there.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core.losses import LOG_CLIP
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values
from repro_torch.core.utils import round_up
from repro_torch.sparse.ccsr import IncrementalBucketBuilder

# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Chunk:
    """One host-side slab of COO entries (possibly containing duplicates)."""
    indices: np.ndarray   # (n, ndim) int32
    values: np.ndarray    # (n,) float32

    def __len__(self) -> int:
        return self.indices.shape[0]


def _linearize64(indices: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Row-major linearized coordinates in int64 (paper-scale shapes exceed
    int32: the full Netflix tensor has ~1.9e13 cells)."""
    lin = np.zeros(indices.shape[0], np.int64)
    for d, s in enumerate(shape):
        lin = lin * np.int64(s) + indices[:, d].astype(np.int64)
    return lin


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the deterministic shard-assignment hash."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _chunk_rng(seed: int, chunk_id: int) -> np.random.Generator:
    """Per-chunk RNG folding: chunk c of stream ``seed`` is reproducible in
    isolation (workers may generate chunks independently)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), chunk_id]))


def _zipf_cdf(n: int, a: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-a)
    return np.cumsum(w) / np.sum(w)


def function_stream(seed: int, shape: Sequence[int], nnz: int,
                    chunk_size: int = 1 << 20) -> Iterator[Chunk]:
    """The Karlsson et al. model problem (paper Fig. 7a) as a chunk stream:
    t_i = sigmoid(3 Σ_d x_d[i_d]), x_d ~ U[-1, 1]. The per-mode grids are
    O(Σ I_d) host memory; each chunk is O(chunk_size)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed)]))
    grids = [rng.uniform(-1.0, 1.0, size=s).astype(np.float32) for s in shape]
    emitted = 0
    chunk_id = 0
    while emitted < nnz:
        n = min(chunk_size, nnz - emitted)
        crng = _chunk_rng(seed, chunk_id)
        idx = np.stack([crng.integers(0, s, size=n, dtype=np.int32)
                        for s in shape], axis=1)
        arg = np.zeros(n, np.float32)
        for d, g in enumerate(grids):
            arg += g[idx[:, d]]
        vals = (1.0 / (1.0 + np.exp(-3.0 * arg))).astype(np.float32)
        yield Chunk(idx, vals)
        emitted += n
        chunk_id += 1


def netflix_stream(seed: int, shape: Sequence[int], nnz: int,
                   chunk_size: int = 1 << 20,
                   zipf_a: float = 1.1) -> Iterator[Chunk]:
    """Netflix-shaped ratings stream (paper Fig. 7b): Zipf-skewed user/movie
    popularity, low-rank bias structure, integer ratings 1..5. Zipf sampling
    can emit repeated coordinates — ``StreamingIngest`` dedups (first stream
    occurrence wins), mirroring the in-memory ``synthetic.netflix_like``."""
    i_dim, j_dim, k_dim = shape
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xB1A5]))
    r = 4
    bu = (0.5 * rng.standard_normal((i_dim, r))).astype(np.float32)
    bv = (0.5 * rng.standard_normal((j_dim, r))).astype(np.float32)
    bw = (0.2 * rng.standard_normal((k_dim, r))).astype(np.float32)
    cdf_i = _zipf_cdf(i_dim, zipf_a)
    cdf_j = _zipf_cdf(j_dim, zipf_a)
    emitted = 0
    chunk_id = 0
    while emitted < nnz:
        n = min(chunk_size, nnz - emitted)
        crng = _chunk_rng(seed, chunk_id)
        ii = np.searchsorted(cdf_i, crng.random(n)).clip(0, i_dim - 1)
        jj = np.searchsorted(cdf_j, crng.random(n)).clip(0, j_dim - 1)
        kk = crng.integers(0, k_dim, size=n)
        base = 3.5 + np.sum(bu[ii] * bv[jj] * (1.0 + bw[kk]), axis=1)
        noise = 0.4 * crng.standard_normal(n).astype(np.float32)
        vals = np.clip(np.round(base + noise), 1.0, 5.0).astype(np.float32)
        idx = np.stack([ii, jj, kk], axis=1).astype(np.int32)
        yield Chunk(idx, vals)
        emitted += n
        chunk_id += 1


def triplet_file_stream(path: str, ndim: int = 3,
                        chunk_size: int = 1 << 20,
                        delimiter: Optional[str] = None,
                        one_based: bool = False,
                        comment: str = "#") -> Iterator[Chunk]:
    """Chunked reader for Netflix-format triplet files: one entry per line,
    ``i_0 ... i_{ndim-1} value`` (whitespace- or ``delimiter``-separated).
    Reads ``chunk_size`` lines at a time — peak memory O(chunk_size)."""
    off = 1 if one_based else 0
    with open(path) as f:
        rows: List[List[float]] = []
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split(delimiter) if delimiter else line.split()
            if len(parts) < ndim + 1:
                raise ValueError(f"{path}: expected {ndim} coordinates + "
                                 f"value per line, got {line!r}")
            rows.append([float(p) for p in parts[:ndim + 1]])
            if len(rows) >= chunk_size:
                yield _rows_to_chunk(rows, ndim, off)
                rows = []
        if rows:
            yield _rows_to_chunk(rows, ndim, off)


def _rows_to_chunk(rows: List[List[float]], ndim: int, off: int) -> Chunk:
    arr = np.asarray(rows, np.float64)
    idx = arr[:, :ndim].astype(np.int32) - np.int32(off)
    if (idx < 0).any():
        raise ValueError("negative coordinate after one_based adjustment")
    return Chunk(idx, arr[:, ndim].astype(np.float32))


STREAMS: dict = {"function": function_stream, "netflix": netflix_stream}


def make_stream(dataset: str, seed: int, shape: Sequence[int], nnz: int,
                chunk_size: int, path: Optional[str] = None,
                zipf_a: float = 1.1) -> Iterator[Chunk]:
    """Stream factory for the experiment harness / benchmarks."""
    if dataset == "file":
        if path is None:
            raise ValueError("dataset='file' needs a triplet file path")
        return triplet_file_stream(path, ndim=len(shape),
                                   chunk_size=chunk_size)
    if dataset == "netflix":
        return netflix_stream(seed, shape, nnz, chunk_size, zipf_a=zipf_a)
    if dataset == "function":
        return function_stream(seed, shape, nnz, chunk_size)
    raise ValueError(f"unknown dataset {dataset!r}")


# ---------------------------------------------------------------------------
# train/test split
# ---------------------------------------------------------------------------

_SPLIT_SALT = np.uint64(0x5EED5A17)


def split_chunk(chunk: Chunk, shape: Sequence[int],
                test_fraction: float) -> Tuple[Chunk, Chunk]:
    """Deterministic per-coordinate train/test split: every occurrence of a
    coordinate lands on the same side (the split commutes with dedup, so
    train and test are disjoint in Ω)."""
    if test_fraction <= 0.0:
        return chunk, Chunk(chunk.indices[:0], chunk.values[:0])
    lin = _linearize64(chunk.indices, shape)
    h = _mix64(lin.astype(np.uint64) ^ _SPLIT_SALT)
    is_test = (h % np.uint64(1 << 16)) < np.uint64(
        int(test_fraction * (1 << 16)))
    tr, te = ~is_test, is_test
    return (Chunk(chunk.indices[tr], chunk.values[tr]),
            Chunk(chunk.indices[te], chunk.values[te]))


# ---------------------------------------------------------------------------
# streaming ingest
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IngestStats:
    """Streamed metadata — the planner's nnz hints come from here, not from
    materialized arrays (``SparseTensor.nnz``/``nnz_rows`` are set from this
    at finalize)."""
    shape: Tuple[int, ...]
    num_shards: int
    entries_read: int = 0        # raw stream entries, before any dedup
    entries_kept: int = 0        # after in-chunk dedup (cross-chunk dups
                                 # are removed at finalize; upper bound)
    nnz: Optional[int] = None    # exact global nnz (set at finalize)
    shard_nnz: Tuple[int, ...] = ()
    nnz_rows: Tuple[int, ...] = ()   # exact nonzero-row count per mode
    chunks: int = 0
    duplicates_dropped: int = 0  # in-chunk + (at finalize) cross-chunk
    # streamed CCSR bucket occupancy (per-mode count arrays), accumulated by
    # ccsr.IncrementalBucketBuilder when ``block_rows`` is set at ingest —
    # pattern builds then need no extra counting pass
    bucket_block_rows: Optional[int] = None
    bucket_counts: Optional[Tuple[np.ndarray, ...]] = None
    # ingest telemetry, set at finalize; mirrored into the
    # obs registry (ingest/* gauges) when tracing is enabled
    ingest_seconds: float = 0.0      # busy time inside add()+finalize
    mnnz_per_s: float = 0.0          # entries_read / ingest_seconds / 1e6
    spills: int = 0                  # spool .npz run files written
    peak_rss_mb: float = 0.0         # process peak RSS (ru_maxrss), host
    # the held-out side's own stats, set by ingest() when it splits (the
    # reference keeps only the training side's)
    test_stats: Optional["IngestStats"] = None


def _dedup_sorted(lin: np.ndarray, order_hint: Optional[np.ndarray] = None):
    """Stable-sort by linearized coordinate and keep the FIRST occurrence of
    each coordinate (stream order); returns (sort_order, keep_mask)."""
    order = np.argsort(lin, kind="stable") if order_hint is None else order_hint
    lin_s = lin[order]
    keep = np.ones(lin_s.shape[0], bool)
    if lin_s.shape[0] > 1:
        keep[1:] = lin_s[1:] != lin_s[:-1]
    return order, keep


class StreamingIngest:
    """Chunk-wise dedup / hash-shard / sort-merge ingest.

    ``add(chunk)`` is O(chunk) time and memory; runs accumulate in memory or,
    with ``spool_dir``, as .npz spill files (out-of-core: host memory stays
    O(chunk) until a shard is finalized, and finalizing materializes one
    shard at a time). ``finalize()`` returns per-shard
    ``(indices, values)`` in canonical order plus :class:`IngestStats`.
    """

    def __init__(self, shape: Sequence[int], num_shards: int = 1,
                 spool_dir: Optional[str] = None,
                 track_rows: bool = True,
                 block_rows: Optional[int] = None,
                 keep_entries: bool = True):
        self.shape = tuple(int(s) for s in shape)
        self.num_shards = int(num_shards)
        self.keep_entries = keep_entries
        self.spool_dir = spool_dir
        if spool_dir is not None:
            os.makedirs(spool_dir, exist_ok=True)
        self._runs: List[List[Tuple[np.ndarray, np.ndarray]]] = [
            [] for _ in range(self.num_shards)]
        self._spilled: List[List[str]] = [[] for _ in range(self.num_shards)]
        self.stats = IngestStats(self.shape, self.num_shards)
        # per-mode nonzero-row occupancy: O(Σ I_d) host memory, exact
        self._row_seen = ([np.zeros(s, bool) for s in self.shape]
                          if track_rows else None)
        self._bucket_builder = None
        if block_rows is not None:
            self._bucket_builder = IncrementalBucketBuilder(self.shape,
                                                            block_rows)
        self._finalized = False
        self._busy_s = 0.0

    # -- streaming phase ---------------------------------------------------
    def add(self, chunk: Chunk) -> None:
        # repro-lint: disable=JS003 -- host numpy work; nothing on the card
        t0 = time.perf_counter()
        try:
            self._add(chunk)
        finally:
            # repro-lint: disable=JS003 -- the same host numpy work
            self._busy_s += time.perf_counter() - t0

    def _add(self, chunk: Chunk) -> None:
        assert not self._finalized, "ingest already finalized"
        n = len(chunk)
        self.stats.entries_read += n
        self.stats.chunks += 1
        if n == 0:
            return
        idx = np.ascontiguousarray(chunk.indices, np.int32)
        vals = np.ascontiguousarray(chunk.values, np.float32)
        lin = _linearize64(idx, self.shape)
        order, keep = _dedup_sorted(lin)
        idx, vals, lin = idx[order][keep], vals[order][keep], lin[order][keep]
        self.stats.duplicates_dropped += n - idx.shape[0]
        self.stats.entries_kept += idx.shape[0]
        if self._row_seen is not None:
            for d in range(len(self.shape)):
                self._row_seen[d][idx[:, d]] = True
        if self._bucket_builder is not None:
            self._bucket_builder.observe(idx)
        if not self.keep_entries:
            # metadata-only mode (``finalize_stats``): the chunk is dropped
            # here — peak host memory is strictly O(chunk)
            return
        shard = (_mix64(lin.astype(np.uint64))
                 % np.uint64(self.num_shards)).astype(np.int64)
        # group by shard with ONE stable sort (preserving the coordinate
        # order within each shard) — O(n log n), not O(num_shards * n)
        by_shard = np.argsort(shard, kind="stable")
        idx, vals, shard = idx[by_shard], vals[by_shard], shard[by_shard]
        bounds = np.searchsorted(shard, np.arange(self.num_shards + 1))
        for s in range(self.num_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if lo == hi:
                continue
            run = (idx[lo:hi].copy(), vals[lo:hi].copy())
            if self.spool_dir is None:
                self._runs[s].append(run)
            else:
                path = os.path.join(
                    self.spool_dir,
                    f"shard{s:04d}_run{len(self._spilled[s]):06d}.npz")
                np.savez(path, indices=run[0], values=run[1])
                self._spilled[s].append(path)
                self.stats.spills += 1
                obs.counter_add("ingest/spills")

    def consume(self, chunks: Iterable[Chunk],
                progress: Optional[Callable[[IngestStats], None]] = None
                ) -> "StreamingIngest":
        for c in chunks:
            self.add(c)
            if progress is not None:
                progress(self.stats)
        return self

    # -- finalize ----------------------------------------------------------
    def _shard_runs(self, s: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        if self.spool_dir is None:
            return self._runs[s]
        out = []
        for path in self._spilled[s]:
            with np.load(path) as z:
                out.append((z["indices"], z["values"]))
        return out

    def finalize_shard(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """Merge shard ``s``'s runs: concat (stream order), stable-sort by
        linearized coordinate, drop cross-chunk duplicates (first stream
        occurrence wins — runs are appended in chunk order, so within equal
        keys the stable sort keeps the earliest chunk's entry first)."""
        runs = self._shard_runs(s)
        if not runs:
            nd = len(self.shape)
            return (np.zeros((0, nd), np.int32), np.zeros((0,), np.float32))
        idx = np.concatenate([r[0] for r in runs])
        vals = np.concatenate([r[1] for r in runs])
        lin = _linearize64(idx, self.shape)
        order, keep = _dedup_sorted(lin)
        return idx[order][keep], vals[order][keep]

    def finalize(self) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], IngestStats]:
        """All shards, canonical order, plus exact stats.

        Shards are merged one at a time and their runs freed as they go, so
        the transient merge footprint is one shard; the RESULT is the full
        materialized tensor (O(nnz) — it is about to become the dataset).
        A consumer that must never hold the whole tensor (e.g. writing
        per-shard files for a multi-host loader) should instead call
        ``finalize_shard(s)`` per shard, or ``finalize_stats()`` for
        metadata alone — both keep the documented O(chunk)/O(shard)
        streaming bound."""
        # repro-lint: disable=JS003 -- the host numpy merge; nothing on the card
        t0 = time.perf_counter()
        shards = []
        dropped_cross = 0
        for s in range(self.num_shards):
            merged = self.finalize_shard(s)
            self._runs[s] = []          # free the source runs shard-by-shard
            shards.append(merged)
        # repro-lint: disable=JS003 -- the same host numpy merge
        self._busy_s += time.perf_counter() - t0
        self._finalized = True
        kept = sum(sh[0].shape[0] for sh in shards)
        dropped_cross = self.stats.entries_kept - kept
        self.stats.duplicates_dropped += dropped_cross
        self.stats.nnz = kept
        self.stats.shard_nnz = tuple(sh[0].shape[0] for sh in shards)
        if self._row_seen is not None:
            self.stats.nnz_rows = tuple(int(r.sum()) for r in self._row_seen)
        if self._bucket_builder is not None:
            self.stats.bucket_block_rows = self._bucket_builder.block_rows
            self.stats.bucket_counts = tuple(self._bucket_builder.counts)
        self._telemetry_finish()
        return shards, self.stats

    def _telemetry_finish(self) -> None:
        """Seal the ingest telemetry: throughput over busy time (generator
        cost excluded — this measures the ingest pipeline, not the source),
        spill count and peak process RSS; mirrored as obs gauges and one
        JSONL event when tracing is enabled."""
        st = self.stats
        st.ingest_seconds = self._busy_s
        st.mnnz_per_s = (st.entries_read / self._busy_s / 1e6
                         if self._busy_s > 0 else 0.0)
        try:
            import resource
            st.peak_rss_mb = (resource.getrusage(resource.RUSAGE_SELF)
                              .ru_maxrss / 1024.0)
        except Exception:            # non-POSIX host: leave the gauge at 0
            pass
        if obs.enabled():
            obs.gauge_set("ingest/mnnz_per_s", st.mnnz_per_s)
            obs.gauge_set("ingest/peak_rss_mb", st.peak_rss_mb)
            obs.gauge_set("ingest/spills", st.spills)
            obs.counter_add("ingest/entries_read", st.entries_read)
            obs.counter_add("ingest/duplicates_dropped",
                            st.duplicates_dropped)
            obs.emit_event({"kind": "ingest", "shape": list(st.shape),
                            "num_shards": st.num_shards, "nnz": st.nnz,
                            "entries_read": st.entries_read,
                            "chunks": st.chunks, "spills": st.spills,
                            "seconds": st.ingest_seconds,
                            "mnnz_per_s": st.mnnz_per_s,
                            "peak_rss_mb": st.peak_rss_mb})

    def finalize_stats(self) -> IngestStats:
        """Metadata-only finalize: stats from the streaming phase without
        loading any run (exact nnz_rows; nnz is the in-chunk-dedup upper
        bound). The out-of-core benchmark path: 'ingest' a paper-scale
        stream and hand the planner its hints with O(chunk) peak memory."""
        self._finalized = True
        self.stats.nnz = self.stats.entries_kept
        self.stats.shard_nnz = ()
        if self._row_seen is not None:
            self.stats.nnz_rows = tuple(int(r.sum()) for r in self._row_seen)
        if self._bucket_builder is not None:
            self.stats.bucket_block_rows = self._bucket_builder.block_rows
            self.stats.bucket_counts = tuple(self._bucket_builder.counts)
        self._telemetry_finish()
        return self.stats


def pack_shards(shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                shape: Sequence[int], stats: Optional[IngestStats] = None,
                pad_multiple: int = 8, device="cuda") -> SparseTensor:
    """Pack per-shard COO arrays into one padded-COO SparseTensor on
    ``device``, laid out in equal-capacity shard blocks ``[shard 0 | shard
    1 | ...]``, with the streamed nnz / nnz_rows hints. One shard's entries
    are sorted by linearized coordinate, hence by mode 0 (``sorted_mode``),
    so mode 0's bucket pattern needs no sort."""
    nd = len(shape)
    cap = round_up(max(max((sh[0].shape[0] for sh in shards), default=1), 1),
                   pad_multiple)
    n_sh = len(shards)
    idx = np.zeros((n_sh * cap, nd), np.int32)
    vals = np.zeros((n_sh * cap,), np.float32)
    valid = np.zeros((n_sh * cap,), bool)
    for s, (si, sv) in enumerate(shards):
        n = si.shape[0]
        idx[s * cap:s * cap + n] = si
        vals[s * cap:s * cap + n] = sv
        valid[s * cap:s * cap + n] = True
    nnz = int(valid.sum())
    nnz_rows = (tuple(stats.nnz_rows) if stats is not None and stats.nnz_rows
                else None)
    return SparseTensor(torch.from_numpy(idx).to(device),
                        torch.from_numpy(vals).to(device),
                        torch.from_numpy(valid).to(device),
                        tuple(int(s) for s in shape), nnz=nnz,
                        sorted_mode=(0 if n_sh == 1 else None),
                        nnz_rows=nnz_rows)


def ingest(chunks: Iterable[Chunk], shape: Sequence[int],
           num_shards: int = 1, spool_dir: Optional[str] = None,
           test_fraction: float = 0.0, pad_multiple: int = 8,
           block_rows: Optional[int] = None, device="cuda"):
    """One-call streaming ingest: returns ``(train_st, test_st, stats)``
    where ``train_st`` is the packed shard-block SparseTensor and
    ``test_st`` the (single-shard) held-out tensor (None when
    ``test_fraction == 0``), both on ``device``; ``stats.test_stats`` holds
    the held-out side's ingest stats. ``block_rows``
    additionally streams the CCSR bucket occupancy counts into the stats
    (incremental pattern build)."""
    tr_ing = StreamingIngest(shape, num_shards, spool_dir=spool_dir,
                             block_rows=block_rows)
    te_ing = (StreamingIngest(shape, 1,
                              spool_dir=None if spool_dir is None else
                              os.path.join(spool_dir, "test"))
              if test_fraction > 0 else None)
    for chunk in chunks:
        tr_chunk, te_chunk = split_chunk(chunk, shape, test_fraction)
        tr_ing.add(tr_chunk)
        if te_ing is not None:
            te_ing.add(te_chunk)
    shards, stats = tr_ing.finalize()
    train = pack_shards(shards, shape, stats, pad_multiple=pad_multiple,
                        device=device)
    del shards
    test = None
    if te_ing is not None:
        te_shards, te_stats = te_ing.finalize()
        test = pack_shards(te_shards, shape, te_stats,
                           pad_multiple=pad_multiple, device=device)
        stats.test_stats = te_stats
    return train, test, stats


# ---------------------------------------------------------------------------
# held-out evaluation
# ---------------------------------------------------------------------------

def heldout_metrics(test_st: SparseTensor, factors,
                    link: str = "identity") -> dict:
    """RMSE and mean Poisson deviance of the CP model on a held-out
    SparseTensor (masked; padding does not contribute). ``link="log"``
    evaluates in rate space (the model parameterizes log-rates, e.g. the
    ``poisson_log`` loss): predictions are exp(model), the model clipped to
    ±``LOG_CLIP`` first. The model values come from the TTTP kernel on the
    card."""
    model = multilinear_values(test_st, list(factors))
    if link == "log":
        model = torch.exp(torch.clamp(model, -LOG_CLIP, LOG_CLIP))
    elif link != "identity":
        raise ValueError(f"unknown link {link!r}")
    t = test_st.values
    mask = test_st.mask
    n = torch.clamp(mask.sum(), min=1)
    se = torch.sum(torch.where(mask, torch.square(t - model), 0.0))
    eps = 1e-6
    m_pos = torch.clamp(model, min=eps)
    tlogt = torch.where(t > 0, t * torch.log(torch.clamp(t, min=eps) / m_pos),
                        0.0)
    dev = 2.0 * torch.sum(torch.where(mask, tlogt - (t - m_pos), 0.0))
    return {"rmse": float(torch.sqrt(se / n)),
            "poisson_deviance": float(dev / n),
            "count": int(n)}
