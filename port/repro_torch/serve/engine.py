"""ServeEngine: the batched query front end over a frozen ServingModel.

Requests come as host arrays of any size; the engine pads each batch up to
a power-of-two bucket (``min_batch`` up to ``max_batch``) and runs:

* ``score``   — entry scoring, TTTP with unit values (``serve.model``);
* ``top_k``   — query-vector build and blocked streaming top-k
                (``serve.topk``), retrieval over any mode;
* ``fold_in`` — batched one-row ALS on the eq.-3 Gram matvec
                (``serve.foldin``), the entry capacity and the bucket
                capacity padded to powers of two.

On the card each endpoint runs one CUDA graph per bucket, as the reference
runs one ``jax.jit`` trace per bucket: the first call of a bucket runs
eagerly (on a side stream, which makes the lazy initialisations: the
kernel library, cuBLAS's workspace) and answers from that run, then
captures the graph over static copies of its inputs; later calls copy their
inputs into those buffers and replay. A failed capture raises. Fold-in's
bucket pattern depends on the data and waits for the device
(``sparse.ccsr.bucket_pattern``), so it is built before the replay, outside
the graph, and the graph's inputs are the bucket view's arrays. A replay
adds the kernel launches its graph holds to ``kernels.ops``'s counts, so
the counts stay true. On the CPU every call runs eagerly.

Every endpoint is wrapped in an ``obs.span`` (fenced: the span covers the
device work) and feeds per-endpoint counters.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.distributed import no_planner_path
from repro_torch.kernels import ops as kops
from repro_torch.serve import foldin as _foldin
from repro_torch.serve import topk as _topk
from repro_torch.serve.model import (ServingModel, apply_link,
                                     multilinear_scores)
from repro_torch.sparse.ccsr import RowBlockBuckets, bucket_pattern


def percentiles(samples_s: Sequence[float]) -> Dict[str, float]:
    """Load-generator summary of per-call wall times (seconds in,
    microseconds out): p50/p95/p99/mean/max over the samples."""
    if not samples_s:
        return {}
    xs = np.sort(np.asarray(samples_s, np.float64)) * 1e6

    def pick(q):
        return float(xs[min(len(xs) - 1, int(q * len(xs)))])

    return {"p50_us": pick(0.50), "p95_us": pick(0.95),
            "p99_us": pick(0.99), "mean_us": float(xs.mean()),
            "max_us": float(xs.max()), "calls": len(xs)}


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < min(n, hi):
        b *= 2
    return b


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


class _Graph:
    """One captured CUDA graph: the static input buffers it reads, its
    outputs (valid after each replay), the kernel launches one replay makes,
    and the result of the eager first call (until the caller takes it)."""

    def __init__(self, fn, static, device: torch.device):
        t0 = time.perf_counter()
        self.static = static
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.first = fn(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with kops.recorded_launches() as held:
            with torch.cuda.graph(self.graph):
                self.out = fn(*static)
        self.launches = held
        self.replays = 0
        torch.cuda.synchronize(device)
        # host seconds of the first call: the eager run and the capture
        self.first_call_s = time.perf_counter() - t0

    def replay(self, inputs):
        for buf, x in zip(self.static, inputs):
            buf.copy_(x)
        self.graph.replay()
        kops.add_launches(self.launches)
        self.replays += 1
        return self.out


class ServeEngine:
    """Serving over one frozen :class:`ServingModel` whose factors all lie
    on ``device`` (``cuda`` unless the caller asks for the CPU).

    ``score_path`` (a planner TTTP candidate) and the planner paths of
    ``foldin_matvec_path`` raise: the planner is not ported yet.
    ``foldin_matvec_path`` None or ``"fused"`` runs the fused CG-matvec
    kernel, ``"tttp_mttkrp"`` TTTP then the MTTKRP."""

    def __init__(self, model: ServingModel, max_batch: int = 4096,
                 min_batch: int = 64, topk_block: int = 4096,
                 score_path: Optional[str] = None,
                 foldin_lam: float = 1e-2,
                 foldin_matvec_path: Optional[str] = None,
                 device="cuda"):
        no_planner_path(score_path)
        self.foldin_route = _foldin.matvec_route(foldin_matvec_path)
        self.device = torch.device(device)
        # the engine gathers factor rows by global index and scans whole
        # factors: every factor must lie whole on the engine's device
        for d, f in enumerate(model.factors):
            if not _same_device(f.device, self.device):
                raise ValueError(
                    f"ServeEngine on {self.device} requires every factor "
                    f"there, but factor {d} is on {f.device}; move the "
                    f"factors (load_factors(..., device=)) first")
        self.model = model
        self.max_batch = int(max_batch)
        self.min_batch = int(min_batch)
        self.topk_block = int(topk_block)
        self.foldin_lam = float(foldin_lam)
        self.graphs: Dict[tuple, _Graph] = {}

    # -- one graph per bucket ------------------------------------------------
    def _run(self, key: tuple, fn, *inputs: torch.Tensor):
        """``fn(*inputs)`` on the engine's device: eagerly on the CPU; on
        the card through the graph of ``key`` (captured at its first call
        over static copies of ``inputs``, whose shapes ``key`` fixes)."""
        if self.device.type != "cuda":
            return fn(*[x.to(self.device) for x in inputs])
        g = self.graphs.get(key)
        if g is None:
            static = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                      for x in inputs]
            for buf, x in zip(static, inputs):
                buf.copy_(x)
            g = self.graphs[key] = _Graph(fn, static, self.device)
            first, g.first = g.first, None
            return first
        return g.replay(inputs)

    def graph_stats(self) -> Dict[str, object]:
        """Graphs captured, replays made and the first calls' seconds."""
        return {"captured": len(self.graphs),
                "replays": sum(g.replays for g in self.graphs.values()),
                "first_call_s": sum(g.first_call_s
                                    for g in self.graphs.values()),
                "launches_per_replay": {
                    "/".join(map(str, k)): g.launches
                    for k, g in self.graphs.items()}}

    # -- endpoints -----------------------------------------------------------
    def score(self, indices, link: Optional[bool] = True) -> np.ndarray:
        """(n,) predictions for (n, ndim) entry indices. ``link=False``
        returns raw model-space values."""
        idx = np.asarray(indices, np.int32)
        if idx.ndim != 2 or idx.shape[1] != self.model.ndim:
            raise ValueError(f"score expects (n, {self.model.ndim}) "
                             f"indices, got {idx.shape}")
        n = idx.shape[0]
        lk = self.model.link if link else "identity"
        fs = self.model.factors
        out = np.empty((n,), _np_dtype(fs[0]))

        def run(batch):
            return apply_link(multilinear_scores(fs, batch), lk)

        with obs.span("serve/score", n=n, link=lk, path="tttp") as sp:
            for lo in range(0, n, self.max_batch):
                chunk = idx[lo:lo + self.max_batch]
                b = _bucket(chunk.shape[0], self.min_batch, self.max_batch)
                pad = np.zeros((b, idx.shape[1]), np.int32)
                pad[:chunk.shape[0]] = chunk
                vals = sp.fence(self._run(("score", b, lk), run,
                                          torch.from_numpy(pad)))
                out[lo:lo + chunk.shape[0]] = \
                    vals[:chunk.shape[0]].cpu().numpy()
            obs.counter_add("serve/queries", n)
        return out

    def top_k(self, fixed: Mapping[int, np.ndarray], target_mode: int,
              k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query top-k over ``target_mode``: ``fixed`` maps each other
        mode to (B,) indices or (B, R) rows; returns (scores, indices), each
        (B, k), scores descending."""
        if target_mode in fixed:
            raise ValueError(f"target mode {target_mode} cannot be fixed")
        fx = {int(d): np.asarray(v) for d, v in fixed.items()}
        sizes = {int(v.shape[0]) for v in fx.values()}
        if len(sizes) != 1:
            raise ValueError(f"fixed modes disagree on batch: {sizes}")
        n = sizes.pop()
        modes = sorted(fx)
        fs = self.model.factors
        sig = tuple((d, fx[d].ndim) for d in modes)
        k = min(int(k), self.model.shape[target_mode])

        def run(*bufs):
            q = _topk.query_rows(fs, dict(zip(modes, bufs)))
            return _topk.topk_over_mode(fs[target_mode], q, k,
                                        block_rows=self.topk_block,
                                        link=self.model.link)

        vals = np.empty((n, k), _np_dtype(fs[0]))
        idx = np.empty((n, k), np.int32)
        with obs.span("serve/top_k", b=n, k=k,
                      target_mode=target_mode) as sp:
            for lo in range(0, n, self.max_batch):
                m = min(n - lo, self.max_batch)
                b = _bucket(m, self.min_batch, self.max_batch)
                bufs = []
                for d in modes:
                    v = fx[d][lo:lo + m]
                    pad = (np.zeros((b,), np.int64) if v.ndim == 1 else
                           np.zeros((b, v.shape[1]), np.float32))
                    pad[:m] = v
                    bufs.append(torch.from_numpy(pad))
                tv, ti = sp.fence(self._run(("top_k", b, target_mode, k, sig),
                                            run, *bufs))
                vals[lo:lo + m] = tv[:m].cpu().numpy()
                idx[lo:lo + m] = ti[:m].cpu().numpy()
            obs.counter_add("serve/topk_queries", n)
        return vals, idx

    def fold_in(self, histories: Sequence[_foldin.History],
                mode: int) -> np.ndarray:
        """(B, R) fresh factor rows for B cold users' histories over the
        other modes (see ``serve.foldin``), in batches of ``max_batch``."""
        total = sum(len(np.asarray(v).reshape(-1)) for _, v in histories)
        rows = np.empty((len(histories), self.model.rank),
                        _np_dtype(self.model.factors[0]))
        with obs.span("serve/fold_in", b=len(histories), nnz=total,
                      mode=mode) as sp:
            for lo in range(0, len(histories), self.max_batch):
                chunk = histories[lo:lo + self.max_batch]
                got = sp.fence(self._fold_in_batch(chunk, mode))
                rows[lo:lo + len(chunk)] = got[:len(chunk)].cpu().numpy()
            obs.counter_add("serve/foldin_users", len(histories))
        return rows

    def history_buckets(self, histories: Sequence[_foldin.History],
                        mode: int) -> RowBlockBuckets:
        """The CCSR bucket view (``block_rows`` 8) of one batch of
        histories on the engine's device: its users padded with empty
        histories to a power-of-two bucket, its entries to a power-of-two
        capacity, and each CCSR bucket to a power-of-two capacity (the
        fullest bucket's occupancy, counted on the host)."""
        shape = self.model.shape
        b = _bucket(len(histories), self.min_batch, self.max_batch)
        empty = (np.zeros((0, len(shape) - 1), np.int32),
                 np.zeros((0,), np.float32))
        padded = list(histories) + [empty] * (b - len(histories))
        counts = np.array([len(np.asarray(v).reshape(-1))
                           for _, v in padded], np.int64)
        cap = _bucket(max(int(counts.sum()), 1), self.min_batch, 1 << 30)
        st = _foldin.pack_histories(padded, shape, mode, cap=cap,
                                    device=self.device)
        br = _foldin.BLOCK_ROWS
        nb = -(-b // br)
        occupancy = np.zeros(nb * br, np.int64)
        occupancy[:b] = counts
        capacity = _bucket(max(int(occupancy.reshape(nb, br).sum(1).max()),
                               1), br, 1 << 30)
        return bucket_pattern(st, mode, br, capacity=capacity).gather(st)

    def _fold_in_batch(self, histories, mode: int) -> torch.Tensor:
        """Fold-in rows of one batch (padded, see :meth:`history_buckets`):
        the graph of its (batch, bucket capacity) runs over the bucket
        view's arrays."""
        bk = self.history_buckets(histories, mode)
        fs = self.model.factors
        route, lam = self.foldin_route, self.foldin_lam
        shape, br = bk.shape, bk.block_rows

        def run(values, indices, local_row, valid):
            view = RowBlockBuckets(values, indices, local_row, valid, mode,
                                   br, shape)
            rows, _ = _foldin.solve_buckets(
                view, _foldin.omega_view(view), fs, lam=lam,
                matvec_path=route)
            return rows

        return self._run(("fold_in", mode, shape[mode], bk.capacity), run,
                         bk.values, bk.indices, bk.local_row, bk.valid)
