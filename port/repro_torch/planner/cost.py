"""Cost model for candidate contraction paths (paper §5.3, DESIGN.md §5.2).

Each candidate path gets a :class:`PathCost` with separate flop and
memory-traffic estimates (in fused multiply-adds and words moved), combined
into a time proxy with machine-balance constants. Only the *ratios* between
paths matter for ranking; the constants are the H100 SXM data sheet's
(about 40 fused multiply-adds per word of HBM traffic).

Formulas (m = nnz, R = rank, N = sparse order, I_d = mode sizes):

* all-at-once MTTKRP / TTTP: Θ(mR·#factors) flops, Θ(mR) transient traffic —
  no intermediate *tensor* is ever formed (paper Fig. 5b "all-at-once");
* pairwise T-first: an extra hypersparse TTM — Θ(mR) flops plus a lexicographic
  sort of the m keys (Θ(m log m) traffic per key column) and a materialized
  Θ(mR) sparse intermediate (paper Fig. 5b "contract with T first");
* pairwise KR-first: the Khatri-Rao product is dense — Θ(K·R) flops *and*
  memory with K = Π_{d≠mode} I_d, which explodes at low density
  (paper §5.3's conclusion: only viable for relatively dense tensors);
* dense fallback: densify and einsum — Θ(Π I_d · R).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from repro_torch.planner import ir as pir

# Machine-balance constants (per second): ranking only depends on the ratio.
# Uncalibrated defaults from the NVIDIA H100 SXM data sheet, not a
# measurement: 67e12 fp32 FLOP/s outside the tensor cores is 3.35e13 fused
# multiply-adds/s; 3.35e12 B/s of HBM3 is 8.4e11 four-byte words/s; 450 GB/s
# of NVLink per direction is about 1.1e11 words/s. ``calibrate`` fits the
# live rates to fenced measurements (§5.3 calibration).
FLOP_RATE = 3.35e13  # fused multiply-adds / s
MEM_RATE = 8.4e11    # words / s
COMM_RATE = 1.1e11   # words / s over NVLink
# words of traffic per element per sort-key column (multi-pass stable argsort)
SORT_WORDS_PER_KEY = 8.0

_DEFAULT_RATES = {"flop": FLOP_RATE, "mem": MEM_RATE, "comm": COMM_RATE}
_RATES = dict(_DEFAULT_RATES)


def rates() -> dict:
    """The live machine-balance rates (a copy)."""
    return dict(_RATES)


def set_rates(flop: float = None, mem: float = None,
              comm: float = None) -> None:
    """Install calibrated rates; None leaves a rate unchanged. Rates must be
    positive — the time proxy divides by them."""
    for key, val in (("flop", flop), ("mem", mem), ("comm", comm)):
        if val is not None:
            if not val > 0:
                raise ValueError(f"{key} rate must be positive, got {val}")
            _RATES[key] = float(val)


def reset_rates() -> None:
    _RATES.update(_DEFAULT_RATES)


def calibrate(samples) -> dict:
    """Fit the flop/mem rates to measured (flops, mem, seconds) samples.

    Least-squares on seconds ≈ flops/flop_rate + mem/mem_rate (the §5.3
    roofline proxy with both terms exposed): solves for the inverse rates
    with a positivity clamp. With fewer than two samples — or when the fit
    degenerates (collinear samples can drive an inverse rate ≤ 0) — falls
    back to scaling both default rates by the median measured/predicted
    ratio, which preserves the default flop:mem balance while matching the
    observed magnitude. Returns the installed rates."""
    samples = [(float(f), float(w), float(s)) for f, w, s in samples
               if s > 0 and (f > 0 or w > 0)]
    if not samples:
        return rates()
    inv = None
    if len(samples) >= 2:
        import numpy as np
        a = np.array([[f, w] for f, w, _ in samples])
        t = np.array([s for _, _, s in samples])
        sol, *_ = np.linalg.lstsq(a, t, rcond=None)
        if sol[0] > 0 and sol[1] > 0:
            inv = sol
    if inv is not None:
        set_rates(flop=1.0 / inv[0], mem=1.0 / inv[1])
    else:
        ratios = sorted(
            s / (f / _DEFAULT_RATES["flop"] + w / _DEFAULT_RATES["mem"])
            for f, w, s in samples)
        scale = ratios[len(ratios) // 2]
        set_rates(flop=_DEFAULT_RATES["flop"] / scale,
                  mem=_DEFAULT_RATES["mem"] / scale)
    return rates()

# Preference order used only to break exact score ties deterministically.
_TIE_ORDER = ("all_at_once", "fused", "tttp_mttkrp", "segment", "dense_output",
              "bucketed", "rowsharded", "sliced", "t_first", "hypersparse",
              "pairwise", "kr_first", "dense")


@dataclasses.dataclass(frozen=True)
class PathCost:
    path: str
    flops: float
    mem: float          # words of memory traffic (input + transient + output)
    comm: float = 0.0   # words moved over mesh links (psum / gather / scatter)
    note: str = ""

    @property
    def seconds(self) -> float:
        """Roofline-style time proxy: compute + traffic + communication
        (not overlapped). Reads the LIVE rates, so calibration
        re-ranks candidate paths process-wide."""
        return (self.flops / _RATES["flop"] + self.mem / _RATES["mem"]
                + self.comm / _RATES["comm"])


def _sort_traffic(m: int, key_cols: int) -> float:
    return m * max(math.log2(max(m, 2)), 1.0) * SORT_WORDS_PER_KEY * key_cols


def _dense_size(ir: pir.ContractionIR) -> float:
    return float(math.prod(ir.sparse.shape))


def _factor_words(ir: pir.ContractionIR) -> float:
    shape = ir.sparse.shape
    r = ir.rank_size
    return float(sum(shape[d] * r for d in ir.factor_modes))


def candidate_paths(ir: pir.ContractionIR) -> List[str]:
    """Legal execution paths for this IR, unranked. Distribution-aware:
    row-sharded factors admit only the gather/scatter schedule, and a
    sharded model axis (column-sliced R) rules out the paths that cannot
    insert the inter-half psum(model) (DESIGN.md §9)."""
    dist = ir.dist or pir.LOCAL_DIST
    if dist.rowsharded:
        if ir.kind == pir.TTTP or (ir.kind == pir.MTTKRP
                                   and pir.is_classic_mttkrp(ir)):
            return ["rowsharded"]
        raise NotImplementedError(
            f"row-sharded factors support TTTP and classic MTTKRP only, "
            f"not {ir.kind!r} ({ir.expr!r})")
    if ir.kind == pir.DENSE:
        return ["dense"]
    if ir.kind == pir.REDUCE:
        return ["segment", "dense"]
    if ir.kind == pir.TTTP:
        return ["all_at_once", "sliced", "pairwise", "dense"]
    if ir.kind == pir.TTM:
        return ["dense_output", "hypersparse", "dense"]
    if ir.kind == pir.MTTKRP:
        if pir.is_classic_mttkrp(ir):
            return ["all_at_once", "bucketed", "t_first", "kr_first", "dense"]
        return ["all_at_once", "dense"]
    if ir.kind == pir.CG_MATVEC:
        if dist.model_size > 1:
            # the contracted rank is column-sharded: the TTTP half must be
            # psum(model)'d before the MTTKRP half — single-pass fusion and
            # the densified fallback cannot express the intermediate psum
            return ["tttp_mttkrp", "sliced"]
        return ["tttp_mttkrp", "fused", "sliced", "dense"]
    raise ValueError(f"unknown IR kind {ir.kind!r}")


def estimate(ir: pir.ContractionIR, path: str) -> PathCost:
    """Flop/traffic/communication estimate for one (IR, path) pair.

    Flop and memory terms use the IR's (per-shard) operand sizes; the
    communication term adds the collective volumes the distribution
    signature implies (paper §4's per-kernel communication analysis), so
    distributed variants rank against local ones on the same scale."""
    cost = _base_estimate(ir, path)
    comm = _comm_words(ir, path)
    return dataclasses.replace(cost, comm=comm) if comm else cost


def _psum_words(volume: float, axis_size: int) -> float:
    """Ring all-reduce of ``volume`` words: ≈2V per device for size > 1."""
    return 2.0 * volume if axis_size > 1 else 0.0


def _comm_words(ir: pir.ContractionIR, path: str) -> float:
    """Collective volume (words per device) for this (IR, path) under the
    IR's distribution signature (DESIGN.md §9)."""
    dist = ir.dist or pir.LOCAL_DIST
    if ir.kind == pir.DENSE or dist.is_local:
        return 0.0
    shape = ir.sparse.shape
    m = float(ir.nnz)
    r = float(ir.rank_size)
    if path == "rowsharded":
        # all-gather each non-target factor's column slices (every device
        # receives the full rows once per sweep over H slices) ...
        gathered = sum(shape[d] * r for d in ir.factor_modes)
        if ir.kind == pir.MTTKRP:
            # ... plus the reduce-scatter of output rows to their owners
            gathered += float(shape[ir.keep_modes[0]]) * r
        return float(gathered)
    if ir.kind == pir.REDUCE:
        out = float(math.prod(shape[d] for d in ir.keep_modes) or 1)
        return _psum_words(out, dist.data_size)
    if ir.kind == pir.TTTP:
        # local partial inner products over the column slice, psum(model)
        return _psum_words(m, dist.model_size)
    if ir.kind == pir.TTM:
        others = float(math.prod(shape[d] for d in range(len(shape))
                                 if d != ir.contract_mode))
        return _psum_words(others * r, dist.data_size)
    if ir.kind == pir.MTTKRP:
        out = float(math.prod(shape[d] for d in ir.keep_modes) or 1) * r
        return _psum_words(out, dist.data_size)
    if ir.kind == pir.CG_MATVEC:
        out = float(shape[ir.keep_modes[0]]) * r
        return (_psum_words(m, dist.model_size)
                + _psum_words(out, dist.data_size))
    return 0.0


def _base_estimate(ir: pir.ContractionIR, path: str) -> PathCost:
    if ir.kind == pir.DENSE:
        # torch.einsum handles its own path; charge the naive product size.
        size = math.prod(s for _, s in ir.sizes)
        return PathCost("dense", float(size), float(size))

    m = float(ir.nnz)
    n = len(ir.sparse.shape)
    shape = ir.sparse.shape
    coo_words = m * (n + 1)          # indices + values

    if ir.kind == pir.REDUCE:
        # hypersparse output bound: rows actually touched (streamed
        # nnz_rows hints and the Θ(m) cap), not the full extent product
        out_words = float(ir.out_cells(ir.keep_modes))
        if path == "segment":
            return PathCost(path, m, coo_words + out_words)
        if path == "dense":
            d = _dense_size(ir)
            return PathCost(path, d, d + coo_words + out_words,
                            note="densify + einsum")

    r = float(ir.rank_size)
    nf = len(ir.factor_modes)

    if ir.kind == pir.TTTP:
        base_in = coo_words + _factor_words(ir)
        if path == "rowsharded":
            # per-slice all-gathered factor columns, discarded after use;
            # gather volume is charged as communication, not memory
            return PathCost(path, m * r * (nf + 1), base_in + m,
                            note="row-sharded per-slice gather (Fig. 2)")
        if path == "all_at_once":
            # the TTTP kernel keeps each nonzero's R-wide product in
            # registers: no (m, R) intermediate lands
            return PathCost(path, m * r * (nf + 1), base_in + m,
                            note="fused gather-product-reduce (TTTP kernel)")
        if path == "sliced":
            # bounds the transient at mR/H but re-reads the COO indices
            # once per slice
            h = _sliced_h(int(r))
            return PathCost(path, m * r * (nf + 1),
                            base_in + (h - 1) * coo_words + m * r / h,
                            note=f"H={h} column slices")
        if path == "pairwise":
            # one materialized (m, R) intermediate per factor contraction
            return PathCost(path, m * r * (nf + 1), base_in + m * r * nf,
                            note="paper Fig. 6 baseline")
        if path == "dense":
            d = _dense_size(ir)
            return PathCost(path, d * r, d + base_in + m)

    if ir.kind == pir.TTM:
        others = float(math.prod(shape[d] for d in range(n)
                                 if d != ir.contract_mode))
        base_in = coo_words + shape[ir.contract_mode] * r
        if path == "dense_output":
            return PathCost(path, m * r, base_in + others * r,
                            note="scatter-add into dense output")
        if path == "hypersparse":
            # sort + segment-sum into ≤ m compressed keys, then densified for
            # the einsum (dense-output) contract; Θ(m) storage until then
            return PathCost(path, m * r,
                            base_in + _sort_traffic(int(m), n - 1) +
                            m * r + others * r,
                            note="compressed-key output, then densified")
        if path == "dense":
            d = _dense_size(ir)
            return PathCost(path, d * r, d + base_in + others * r)

    if ir.kind == pir.MTTKRP:
        out_words = float(ir.out_cells(ir.keep_modes)) * r
        base_in = coo_words + _factor_words(ir)
        if path == "all_at_once":
            return PathCost(path, m * r * nf, base_in + m * r + out_words,
                            note="gather-product-segment-sum")
        if path == "bucketed":
            # Consumes the ingest-time cached RowBlockBuckets view attached
            # to the SparseTensor (values gathered through the cached
            # pattern once per tensor), so no per-call bucketize is charged;
            # the port's dispatch lowers all_at_once onto the same view.
            return PathCost(path, m * r * nf, base_in + m * r + out_words,
                            note="ingest-cached buckets + one-hot matmul")
        if path == "rowsharded":
            return PathCost(path, m * r * nf, base_in + m * r + out_words,
                            note="row-sharded gather + psum-scatter (Fig. 2)")
        if path == "t_first":
            mode = ir.keep_modes[0]
            last = [d for d in range(n) if d != mode][-1]
            flops = m * r + m * r * max(nf - 1, 1)
            mem = (base_in + _sort_traffic(int(m), n - 1) + m * r + out_words)
            return PathCost(path, flops, mem,
                            note=f"hypersparse TTM over mode {last} first")
        if path == "kr_first":
            mode = ir.keep_modes[0]
            k = float(math.prod(shape[d] for d in range(n) if d != mode))
            flops = k * r * max(nf - 1, 1) + m * r
            return PathCost(path, flops, base_in + k * r + out_words,
                            note="dense Khatri-Rao intermediate, Θ(K·R) memory")
        if path == "dense":
            d = _dense_size(ir)
            return PathCost(path, d * r, d + base_in + out_words)

    if ir.kind == pir.CG_MATVEC:
        # nf = non-target factors per half; the contracted-rank half also
        # reads x (counted in _factor_words via factor_modes)
        nf = n - 1
        out_words = float(ir.out_cells(ir.keep_modes)) * r
        base_in = coo_words + _factor_words(ir)
        if path == "tttp_mttkrp":
            # TTTP then MTTKRP: the Khatri-Rao rows are gathered twice, and
            # a Θ(m) z intermediate lands between the halves
            return PathCost(path, m * r * (2 * nf + 1),
                            base_in + 2 * m + out_words,
                            note="TTTP + MTTKRP composition (eq. 3)")
        if path == "fused":
            # one pass per nonzero, KR gather shared across both halves,
            # over the ingest-time cached buckets (no per-call bucketize)
            return PathCost(path, m * r * (nf + 2), base_in + out_words,
                            note="fused single-pass kernel, cached buckets")
        if path == "sliced":
            h = _sliced_h(int(r))
            return PathCost(path, m * r * (2 * nf + 1),
                            base_in + (h - 1) * coo_words + m * r / h +
                            2 * m + out_words,
                            note=f"H={h} column slices on both halves")
        if path == "dense":
            d = _dense_size(ir)
            return PathCost(path, 2 * d * r, d + base_in + out_words)

    raise ValueError(f"no cost formula for kind={ir.kind!r} path={path!r}")


def _sliced_h(r: int) -> int:
    """Static H for the sliced TTTP schedule: largest of {4, 2, 1} dividing R."""
    for h in (4, 2):
        if r % h == 0:
            return h
    return 1


def rank_paths(ir: pir.ContractionIR) -> Tuple[PathCost, ...]:
    """All candidates, cheapest-first (deterministic tie-break)."""
    costs = [estimate(ir, p) for p in candidate_paths(ir)]
    return tuple(sorted(costs, key=lambda c: (c.seconds,
                                              _TIE_ORDER.index(c.path))))
