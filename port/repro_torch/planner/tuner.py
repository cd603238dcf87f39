"""Measured kernel-tile tuning with a persistent on-disk plan cache: the
port's counterpart of the reference's ``planner/tuner.py``.

The planner's one-shot ``autotune=True`` times candidate *paths*; this
module tunes the *launch shapes* underneath them: for each kernel family it
sweeps a small lattice of :class:`~repro_torch.kernels.tile.KernelTile`
candidates (threads per CTA, slots or nonzeros per thread), times each with
fenced ``obs.span`` measurements (so the timings land in the same registry
as the planner's spans), records every candidate into the
predicted-against-measured ``PlanRecord`` table, installs the winner into
the process-wide tile table (``kernels.tile.set_tile``), and calibrates the
cost model's rates (``planner.cost.set_rates``) from the same
measurements. The footprint model (``kernels.footprint``) prunes a lattice
before anything is timed.

Winners persist to an on-disk JSON plan cache keyed by

    (device kind, lattice version, family, plan signature, footprint budget)

so a second run of the same workload performs no timing at all: the cache
entry re-installs the tile and the stored rates. Any key component changing
(another card, a new lattice version, another tensor signature, another
shared-memory budget) misses by construction and re-measures. The cache
path comes from ``REPRO_PLAN_CACHE`` or the ``--plan-cache`` flag of
``launch/complete.py`` and ``launch/experiment.py``.

Caveat: a tile reaches a kernel when a wrapper launches it, so retuning
re-tiles future launches only. CUDA graphs already captured (the serving
engine's, one per key) replay the tile they captured with, as the
reference's jitted callers keep the tile they traced with: tune at start-up,
before the first capture.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels.tile import (DEFAULT_TILE, FAMILIES, KernelTile,
                                      current_tile, set_tile)
from repro_torch.planner import cost as pcost

# Bump when the candidate set below changes shape: stale cached winners from
# an older lattice must re-measure, not silently win against new candidates.
LATTICE_VERSION = 1

# Per-family candidate tiles. The default tile is always first, so the
# measured winner is never slower than the default launch. Each candidate is
# a (threads, per_thread) instantiation the kernels are compiled for.
_CANDIDATES = (DEFAULT_TILE,
               KernelTile(threads=256, per_thread=1),
               KernelTile(threads=256, per_thread=4),
               KernelTile(threads=128, per_thread=2),
               KernelTile(threads=128, per_thread=4),
               KernelTile(threads=64, per_thread=4))
LATTICES: Dict[str, Tuple[KernelTile, ...]] = {f: _CANDIDATES
                                                for f in FAMILIES}

# the planner path each family's tuned kernel realises (PlanRecord rows)
_FAMILY_PATH = {"tttp": "all_at_once", "mttkrp": "bucketed",
                "cg_matvec": "fused"}

_MODE_LETTERS = "abcdefghij"


def _sync(out) -> None:
    obs.synchronize(out.values if isinstance(out, SparseTensor) else out)


def fenced_time(fn, iters: int = 3, span_name: str = "tuner/measure",
                **attrs) -> float:
    """Best-of-``iters`` wall time of ``fn()`` after one warm-up call, each
    run fenced by a synchronisation of the devices its output lies on
    (``torch.cuda.synchronize``; nothing to wait for on the CPU). Every
    timed run sits in an ``obs.span``, so with tracing on the timings land
    in the registry beside the planner's spans."""
    _sync(fn())
    best = float("inf")
    for _ in range(iters):
        with obs.span(span_name, **attrs):
            t0 = time.perf_counter()
            _sync(fn())
            best = min(best, time.perf_counter() - t0)
    return best


def _family_ir(family: str, st, factors):
    """The ContractionIR whose §5.3 estimate prices this family's tuned
    kernel (the mode-0 form, the shape every solver sweep hits first)."""
    from repro_torch.planner import ir as pir
    s = _MODE_LETTERS[:st.ndim]
    if family == "tttp":
        expr = ",".join([s] + [s[d] + "z" for d in range(st.ndim)]) + "->" + s
        operands = (st, *factors)
    elif family == "mttkrp":
        expr = (",".join([s] + [s[d] + "z" for d in range(1, st.ndim)])
                + "->" + s[0] + "z")
        operands = (st, *factors[1:])
    elif family == "cg_matvec":
        others = range(1, st.ndim)
        expr = (",".join([s] + [s[d] + "z" for d in others] + [s[0] + "y"]
                         + [s[d] + "y" for d in others])
                + "->" + s[0] + "z")
        operands = (st, *factors[1:], factors[0], *factors[1:])
    else:
        raise KeyError(f"unknown kernel family {family!r}")
    return pir.build_ir(expr, operands)


def _family_runner(family: str, tile: KernelTile, st, omega, factors, x):
    """An argless callable running this family's kernel wrapper under
    ``tile``: the thing the tuner times (the plain version on the CPU)."""
    from repro_torch.kernels import ops as kops
    if family == "tttp":
        return lambda: kops.tttp_values(st, factors, tile=tile)
    fs = [None] + list(factors[1:])
    if family == "mttkrp":
        buckets = st.row_buckets(0, tile.block_rows)
        return lambda: kops.mttkrp_bucketed(buckets, fs,
                                            num_rows=st.shape[0], tile=tile)
    if family == "cg_matvec":
        buckets = omega.row_buckets(0, tile.block_rows)
        return lambda: kops.cg_matvec_bucketed(buckets, fs, x,
                                               num_rows=st.shape[0],
                                               tile=tile)
    raise KeyError(f"unknown kernel family {family!r}")


def tune_family(family: str, st, factors, omega=None, x=None,
                lattice: Optional[Sequence[KernelTile]] = None,
                iters: int = 3) -> Dict:
    """Time every lattice candidate for one family, install the winner, and
    return ``{"tile", "seconds", "timings", "footprint_pruned",
    "predicted"}``. Candidates the footprint model rejects are counted
    (``tuner/footprint_pruned``) and never timed; each timed candidate
    bumps ``tuner/measurements`` and lands a PlanRecord keyed
    ``autotune/<family>|<path>|tile:<short>``. The launches the timing
    makes are taken back out of the kernels' launch counts."""
    from repro_torch.kernels import footprint
    from repro_torch.kernels import ops as kops
    lattice = tuple(lattice if lattice is not None else LATTICES[family])
    src = omega if (family == "cg_matvec" and omega is not None) else st
    if family == "cg_matvec" and x is None:
        x = factors[0]
    kept, pruned = footprint.prune_lattice(
        family, lattice,
        lambda t: footprint.workload_geometry(family, src, factors, t, x=x))
    if pruned:
        obs.counter_add("tuner/footprint_pruned", len(pruned))
        if not kept:
            detail = "\n".join(e.format() for _, e in pruned)
            raise ValueError(
                f"every {family!r} lattice candidate exceeds the footprint "
                f"budget ({footprint.smem_budget_bytes()} B of shared memory "
                f"per CTA) — raise REPRO_SMEM_KB or add smaller tiles:\n"
                f"{detail}")
    ir = _family_ir(family, st, factors)
    path = _FAMILY_PATH[family]
    cost = pcost.estimate(ir, path)
    predicted = {"flops": cost.flops, "mem": cost.mem, "comm": cost.comm,
                 "seconds": cost.seconds}
    timings: List[Tuple[KernelTile, float]] = []
    with kops.recorded_launches():
        for tile in kept:
            run = _family_runner(family, tile, st, omega, factors, x)
            seconds = fenced_time(
                run, iters=iters, span_name=f"tuner/{family}",
                tile=tile.short(), nnz=ir.nnz, rank=ir.rank_size)
            obs.counter_add("tuner/measurements")
            obs.get_registry().record_plan(
                f"autotune/{family}|{path}|tile:{tile.short()}",
                str(ir.kind), path, ir.expr, predicted, seconds)
            timings.append((tile, seconds))
    winner, best = min(timings, key=lambda t: t[1])
    set_tile(family, winner)
    return {"tile": winner, "seconds": best,
            "timings": [(t.short(), s) for t, s in timings],
            "footprint_pruned": [(t.short(), e.total) for t, e in pruned],
            "predicted": predicted}


# ---------------------------------------------------------------------------
# persistent on-disk plan cache
# ---------------------------------------------------------------------------

def device_kind(tensor: Optional[torch.Tensor] = None) -> str:
    """The card's name (``torch.cuda.get_device_name``) where ``tensor``
    lies on a card (with no tensor: where one is present), ``"cpu"``
    otherwise."""
    on_card = (tensor.device.type == "cuda" if tensor is not None
               else torch.cuda.is_available())
    return (torch.cuda.get_device_name(tensor.device if tensor is not None
                                       else None) if on_card else "cpu")


def plan_signature(st, factors) -> str:
    """Static signature of the tuned workload: tile winners transfer across
    runs of the same (shape, nnz, rank, dtype) tensor only. The dtype reads
    as the reference prints it (``float32``)."""
    r = next(int(f.shape[1]) for f in factors if f is not None)
    dt = str(st.values.dtype).replace("torch.", "")
    return (f"shape={'x'.join(str(s) for s in st.shape)}|nnz={st.nnz}"
            f"|cap={st.cap}|r={r}|dt={dt}")


def cache_key(family: str, st, factors,
              lattice_version: Optional[int] = None) -> str:
    from repro_torch.kernels.footprint import smem_budget_bytes
    v = LATTICE_VERSION if lattice_version is None else lattice_version
    # the footprint budget is part of key validity: a winner tuned under one
    # budget may be a pruned (unrunnable) candidate under a smaller one
    return (f"{device_kind(st.values)}|v{v}|{family}"
            f"|{plan_signature(st, factors)}|smem={smem_budget_bytes()}")


class PlanCacheFile:
    """The on-disk winner store: a flat JSON object of full cache keys →
    ``{tile, seconds, timings}`` plus the calibrated rates. Unknown or
    stale keys (another device kind, lattice version, signature or budget)
    simply never match: invalidation by key construction, no file-level
    state."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.entries: Dict[str, Dict] = {}
        self.rates: Optional[Dict[str, float]] = None
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                self.entries = dict(data.get("entries", {}))
                self.rates = data.get("rates")
            except (OSError, ValueError, AttributeError):
                self.entries = {}
                self.rates = None

    def get(self, key: str) -> Optional[KernelTile]:
        entry = self.entries.get(key)
        if entry is None:
            return None
        try:
            return KernelTile.from_json(entry["tile"])
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, key: str, result: Dict) -> None:
        self.entries[key] = {"tile": result["tile"].to_json(),
                             "seconds": result["seconds"],
                             "timings": result["timings"]}

    def save(self) -> None:
        if not self.path:
            return
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"lattice_version": LATTICE_VERSION,
                       "entries": self.entries, "rates": self.rates},
                      f, indent=2, sort_keys=True)


def ensure_tuned(st, factors, omega=None, x=None,
                 families: Optional[Sequence[str]] = None,
                 cache_path: Optional[str] = None,
                 calibrate: bool = True, iters: int = 3) -> Dict:
    """Tune (or restore from the cache) the kernel tiles for ``families``
    and return a summary ``{"hits", "measured", "footprint_pruned",
    "winners", "cache_path", "rates"}``.

    Per family: a cache hit installs the stored tile with no timing
    (counter ``tuner/cache_hits``); a miss sweeps the lattice, installs the
    winner and stores it. ``cache_path`` defaults to ``REPRO_PLAN_CACHE``;
    None or empty disables persistence (always measures). Fresh
    measurements calibrate the cost model's rates (``tuner/calibrations``)
    and persist them; a fully cached run re-installs the stored rates. The
    cg_matvec family needs ``omega`` (the Ω indicator tensor) and is skipped
    without it; ``x`` defaults to the mode-0 factor (the CG direction's
    shape)."""
    cache_path = (cache_path if cache_path is not None
                  else os.environ.get("REPRO_PLAN_CACHE") or None)
    if families is None:
        families = [f for f in FAMILIES
                    if f != "cg_matvec" or omega is not None]
    if x is None:
        x = factors[0]
    cache = PlanCacheFile(cache_path)
    summary: Dict = {"hits": 0, "measured": 0, "footprint_pruned": 0,
                     "winners": {}, "cache_path": cache_path}
    samples = []
    fresh = False
    for family in families:
        key = cache_key(family, st, factors)
        tile = cache.get(key)
        if tile is not None:
            set_tile(family, tile)
            obs.counter_add("tuner/cache_hits")
            summary["hits"] += 1
            summary["winners"][family] = tile.short()
            continue
        result = tune_family(family, st, factors, omega=omega, x=x,
                             iters=iters)
        cache.put(key, result)
        fresh = True
        summary["measured"] += len(result["timings"])
        summary["footprint_pruned"] += len(result["footprint_pruned"])
        summary["winners"][family] = result["tile"].short()
        p = result["predicted"]
        samples.append((p["flops"], p["mem"], result["seconds"]))
    if calibrate:
        if samples:
            cache.rates = pcost.calibrate(samples)
            obs.counter_add("tuner/calibrations")
        elif cache.rates:
            # fully cached: restore the rates the original measurements fit
            pcost.set_rates(**{k: cache.rates.get(k) for k in
                               ("flop", "mem", "comm")})
    if fresh and cache_path:
        cache.save()
    summary["rates"] = pcost.rates()
    return summary


def tiles_summary() -> Dict[str, str]:
    return {f: current_tile(f).short() for f in FAMILIES}
