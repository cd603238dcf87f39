"""Static footprint model of the CUDA kernels on Hopper: the port's
counterpart of the reference's ``kernels/vmem.py``, which prices a Pallas
tile's VMEM residency against a TPU core's budget.

What limits a CUDA launch is what one CTA holds on an SM, so this module
prices that, per CTA, from a :class:`~repro_torch.kernels.tile.KernelTile`
and the workload's geometry alone (no launch):

* dynamic shared memory, exact (``csrc/bucket_rows.cuh`` ``bucket_smem``):
  ``a · warps · block_rows · RS`` bytes for the bucketed body's output rows,
  one slab per warp of the CTA (the deterministic in-bucket sum,
  ``csrc/scatter_rows.cuh``), held in the accumulator, ``a`` = 4 bytes
  (float, for float32 and bf16 operands in a float32 tile) or 8 (double,
  for float64 operands or a float64 tile); and for the fused matvec
  ``c · block_rows · RS`` bytes of x's rows in the compute type, ``c`` = 4
  (float32 and bf16 operands) or 8 (float64); RS the widest launch's padded
  row in elements (R rounded up to a 16-byte vector, 4 floats, 8 bf16
  values or 2 doubles, at most 128); none for TTTP;
* registers per thread and static shared memory: the compiler's counts
  for the instantiation the launch takes (its element type and
  accumulator included),
  from the build log
  (``_build.resource_usage``), or, before a build, the launch-bounds cap
  of 255 registers and no static shared memory;
* threads per CTA.

The budgets are the H100's (CUDA C++ Programming Guide, compute capability
9.0): 227 KB (232 448 B) of shared memory a CTA may opt in to and 228 KB
per SM, 65 536 registers per SM and 255 per thread, and the kernels'
``MAX_THREADS`` (256) threads per CTA. On the card the shared-memory and
register figures come from ``torch.cuda.get_device_properties`` where
PyTorch gives them; ``REPRO_SMEM_KB`` overrides the shared-memory budget
(as ``REPRO_VMEM_MB`` does the reference's), so tests can force a prune.

``planner.tuner`` prunes a lattice with :func:`prune_lattice` before it
times anything, and the budget is part of its plan-cache key;
``kernels.mttkrp`` checks its launches against
:data:`SMEM_PER_BLOCK_OPTIN` with :func:`dynamic_smem_bytes`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.utils import round_up
from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp import MAX_RANK, padded_width
from repro_torch.kernels.tile import MAX_THREADS, KernelTile

# H100 (compute capability 9.0) per-CTA and per-SM limits
SMEM_PER_BLOCK_OPTIN = 232_448      # 227 KB, dynamic, after opting in
SMEM_PER_SM = 233_472               # 228 KB
SMEM_RESERVED_PER_BLOCK = 1_024     # the runtime's own per CTA
REGS_PER_SM = 65_536
REGS_PER_THREAD = 255               # also the launch-bounds cap
REG_ALLOC_UNIT = 256                # registers are allocated per warp
# an SM's register file is split over its 4 sub-partitions (one warp
# scheduler each); a warp's registers come from one of them, so registers
# limit warps per sub-partition, not per SM
SM_SUB_PARTITIONS = 4
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
# the bucketed body's instantiations (csrc/bucket_rows.cuh launch_bucket_rows)
RMAX_VARIANTS = (16, 32, 64, 128)


def _props():
    return (torch.cuda.get_device_properties(0)
            if torch.cuda.is_available() else None)


def smem_budget_bytes() -> int:
    """The per-CTA shared-memory budget the model prunes against:
    ``REPRO_SMEM_KB`` if set, else the card's opt-in limit, else the
    H100's."""
    kb = os.environ.get("REPRO_SMEM_KB")
    if kb:
        return int(float(kb) * 1024)
    return int(getattr(_props(), "shared_memory_per_block_optin",
                       SMEM_PER_BLOCK_OPTIN))


def limits() -> Dict[str, int]:
    """The budgets of :func:`estimate_footprint` (the card's where PyTorch
    reports them)."""
    p = _props()
    return {"smem_per_block": smem_budget_bytes(),
            "smem_per_sm": int(getattr(p, "shared_memory_per_multiprocessor",
                                       SMEM_PER_SM)),
            "regs_per_sm": int(getattr(p, "regs_per_multiprocessor",
                                       REGS_PER_SM)),
            "regs_per_thread": REGS_PER_THREAD,
            "max_threads": MAX_THREADS,
            "threads_per_sm": int(getattr(p, "max_threads_per_multi_processor",
                                          THREADS_PER_SM))}


def row_width(rank: int, dtype: torch.dtype = torch.float32) -> int:
    """RS, the padded row (in elements of ``dtype``) of the bucketed body's
    widest launch."""
    return padded_width(min(rank, MAX_RANK), dtype)


def accum_bytes(dtype: torch.dtype,
                acc: Optional[torch.dtype] = None) -> int:
    """Bytes of one accumulator value of the bucketed body on ``dtype``
    operands summed in ``acc`` (default: their own accumulator, double for
    float64, float otherwise)."""
    acc = _build.natural_accumulator(dtype) if acc is None else acc
    return acc.itemsize


def compute_bytes(dtype: torch.dtype) -> int:
    """Bytes of one value of the compute type of ``dtype`` operands (x's
    shared rows in the fused matvec): double for float64, float
    otherwise."""
    return 8 if dtype == torch.float64 else 4


def dynamic_smem_bytes(block_rows: int, rank: int, fused: bool,
                       dtype: torch.dtype = torch.float32,
                       threads: int = MAX_THREADS,
                       acc: Optional[torch.dtype] = None) -> int:
    """Dynamic shared memory of one bucketed CTA of ``threads`` threads on
    ``dtype`` operands summed in ``acc``: one slab of ``block_rows`` output
    rows of RS accumulator values per warp, and ``block_rows`` rows of x in
    the compute type when ``fused`` (``csrc/bucket_rows.cuh``
    ``bucket_smem``)."""
    rows = block_rows * row_width(rank, dtype)
    warps = -(-threads // 32)
    return (accum_bytes(dtype, acc) * warps * rows
            + (compute_bytes(dtype) * rows if fused else 0))


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """Static workload geometry one kernel instance runs against.

    ``factor_rows`` are the row extents of the factors the kernel gathers
    (the present ones for TTTP, the non-target ones for the bucketed
    kernels); ``capacity`` is the padded-COO cap (TTTP) or the CCSR bucket
    capacity (bucketed kernels); ``x_rows`` is the CG direction's row
    extent (cg_matvec only); ``dtype`` the operands' element type, which
    picks the instantiation and the padded row."""
    nd: int
    rank: int
    factor_rows: Tuple[int, ...]
    capacity: int
    block_rows: int = 8
    x_rows: Optional[int] = None
    dtype: torch.dtype = torch.float32
    index_bytes: int = 4


def _fused(family: str, rank: int) -> bool:
    # wider R runs the Gram matvec as TTTP + MTTKRP (kernels.ops)
    return family == "cg_matvec" and rank <= MAX_RANK


def instantiation(family: str, geom: KernelGeometry, tile: KernelTile
                  ) -> Tuple[str, int, Tuple[str, Tuple]]:
    """(family the launch takes, template variant, build-log key) of the
    kernel ``family`` launches on ``geom`` under ``tile``: TTTP's NP (the
    present factors) or the bucketed body's RMAX, with the tile's depth,
    the geometry's element type and, where the tile widens it, the
    accumulator (``_build.kernel_name``'s keys)."""
    dt = (_build.dtype_name(geom.dtype),)
    if tile.widens(geom.dtype):
        dt += (_build.dtype_name(tile.accumulator(geom.dtype)),)
    if family == "tttp":
        np_ = len(geom.factor_rows)
        return "tttp", np_, ("tttp_kernel", (np_, tile.per_thread, *dt))
    if family not in ("mttkrp", "cg_matvec"):
        raise KeyError(f"unknown kernel family {family!r}")
    fused = _fused(family, geom.rank)
    rmax = next(v for v in RMAX_VARIANTS
                if v >= row_width(geom.rank, geom.dtype))
    return (("cg_matvec" if fused else "mttkrp"), rmax,
            ("bucket_rows_kernel", (rmax, int(fused), tile.per_thread, *dt)))


@dataclasses.dataclass(frozen=True)
class FootprintEstimate:
    """What one CTA of a tile holds, against the budgets. ``total`` is the
    shared-memory bytes (the budget ``REPRO_SMEM_KB`` moves)."""
    family: str
    tile_short: str
    kernel: str
    smem_bytes: int
    registers: int
    registers_from: str                 # "build log" or "launch-bounds cap"
    static_smem: int
    threads: int
    budget: int
    limits: Tuple[Tuple[str, int], ...]
    breakdown: Tuple[Tuple[str, int], ...]

    @property
    def total(self) -> int:
        return self.smem_bytes

    @property
    def fits(self) -> bool:
        lim = dict(self.limits)
        return (self.smem_bytes <= self.budget
                and self.threads <= lim["max_threads"]
                and self.registers <= lim["regs_per_thread"]
                and self.registers * self.threads <= lim["regs_per_sm"])

    @property
    def blocks_per_sm(self) -> int:
        """CTAs one SM holds at once by this model: the least of the
        thread, register (per-warp allocation, warps per sub-partition)
        and shared-memory limits."""
        lim = dict(self.limits)
        warps = -(-self.threads // 32)
        per_warp = round_up(max(self.registers, 1) * 32, REG_ALLOC_UNIT)
        per_part = lim["regs_per_sm"] // SM_SUB_PARTITIONS
        by_regs = SM_SUB_PARTITIONS * (per_part // per_warp) // warps
        by_smem = lim["smem_per_sm"] // (self.smem_bytes
                                         + SMEM_RESERVED_PER_BLOCK)
        return min(lim["threads_per_sm"] // self.threads, by_regs, by_smem,
                   BLOCKS_PER_SM)

    def format(self) -> str:
        parts = " + ".join(f"{k}={v}" for k, v in self.breakdown)
        verdict = "fits" if self.fits else "OVER"
        return (f"{self.family}[{self.tile_short}] {self.kernel}: "
                f"{self.smem_bytes} B shared ({verdict}: budget "
                f"{self.budget} B; {parts}), {self.registers} registers x "
                f"{self.threads} threads ({self.registers_from}), "
                f"{self.blocks_per_sm} CTAs per SM")


def estimate_footprint(family: str, tile: KernelTile, geom: KernelGeometry,
                       budget: Optional[int] = None) -> FootprintEstimate:
    """Per-CTA footprint of ``family`` under ``tile`` on ``geom`` (see the
    module docstring)."""
    lim = limits()
    if budget is not None:
        lim["smem_per_block"] = int(budget)
    launched, variant, key = instantiation(family, geom, tile)
    parts: List[Tuple[str, int]] = []
    if launched != "tttp":
        rows = geom.block_rows * row_width(geom.rank, geom.dtype)
        acc = tile.accumulator(geom.dtype)
        parts.append(("warp slabs", accum_bytes(geom.dtype, acc)
                      * -(-tile.threads // 32) * rows))
        if launched == "cg_matvec":
            parts.append(("x rows", compute_bytes(geom.dtype) * rows))
    usage = _build.resource_usage().get(key)
    regs, static, source = ((usage["registers"], usage["smem"], "build log")
                            if usage else
                            (REGS_PER_THREAD, 0, "launch-bounds cap"))
    if static:
        parts.append(("static", static))
    args = ", ".join(map(str, key[1]))
    return FootprintEstimate(
        family=family, tile_short=tile.short(), kernel=f"{key[0]}<{args}>",
        smem_bytes=sum(v for _, v in parts), registers=regs,
        registers_from=source, static_smem=static, threads=tile.threads,
        budget=lim["smem_per_block"], limits=tuple(sorted(lim.items())),
        breakdown=tuple(parts) or (("none", 0),))


def workload_geometry(family: str, st, factors, tile: KernelTile,
                      x=None) -> KernelGeometry:
    """Geometry for one concrete tuner workload. For the bucketed families
    the capacity is the CCSR bucket capacity ``tile.block_rows`` implies in
    mode 0 (as ``tuner._family_runner`` buckets), rounded up to 8 as the
    reference rounds it."""
    nd = len(st.shape)
    rank = next(int(f.shape[1]) for f in factors if f is not None)
    dt = st.values.dtype
    if family == "tttp":
        rows = tuple(int(f.shape[0]) for f in factors if f is not None)
        return KernelGeometry(nd=nd, rank=rank, factor_rows=rows,
                              capacity=int(st.cap),
                              block_rows=tile.block_rows, dtype=dt)
    rows = tuple(int(f.shape[0]) for d, f in enumerate(factors)
                 if d != 0 and f is not None)
    idx = st.indices[:, 0][st.valid].long()
    occ = torch.bincount(idx // tile.block_rows) if idx.numel() else None
    # repro-lint: disable=JS002 -- tuner geometry, once per workload
    cap = round_up(max(int(occ.max()) if occ is not None else 1, 1), 8)
    x_rows = int(x.shape[0]) if (family == "cg_matvec" and x is not None) \
        else (int(st.shape[0]) if family == "cg_matvec" else None)
    return KernelGeometry(nd=nd, rank=rank, factor_rows=rows, capacity=cap,
                          block_rows=tile.block_rows, x_rows=x_rows,
                          dtype=dt)


def prune_lattice(family: str, lattice: Sequence[KernelTile],
                  geom_fn: Callable[[KernelTile], KernelGeometry],
                  budget: Optional[int] = None
                  ) -> Tuple[List[KernelTile],
                             List[Tuple[KernelTile, FootprintEstimate]]]:
    """Split a tile lattice into (fits, pruned-with-estimates). ``geom_fn``
    maps each tile to its geometry (the bucket capacity depends on the
    tile's block_rows)."""
    kept: List[KernelTile] = []
    pruned: List[Tuple[KernelTile, FootprintEstimate]] = []
    for tile in lattice:
        est = estimate_footprint(family, tile, geom_fn(tile), budget=budget)
        if est.fits:
            kept.append(tile)
        else:
            pruned.append((tile, est))
    return kept, pruned
