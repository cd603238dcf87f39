"""SPMD pass 3 — the shared-memory and register certificate of the tile
lattices: the port's counterpart of the JAX package's
``analysis/spmd/vmem.py``.

Prices every tile of ``planner.tuner.LATTICES``, for each kernel family and
in every element type and accumulator the kernels are instantiated for
(float32, bfloat16, float64 in their own accumulators, and float32 and
bfloat16 summed in float64: each tile again with ``accum_dtype="float64"``;
one warp slab per warp at the accumulator's bytes, x's rows at the compute
type's, and each instantiation's own registers), with the footprint model
of ``kernels/footprint.py``, and
reports ``SP201`` for a tile that does not fit the card: more dynamic
shared memory than a CTA may opt in to, more than 255 registers a thread,
or more registers than an SM holds for one CTA. The model backs the
tuner's online pruning (a tile that does not fit is never timed); this
pass certifies the shipped lattice before any tuner runs. Registers are
the build log's where a build exists (on the card), else the
launch-bounds cap.

Two tiers of layouts:

* the default tier, the port's own layouts: the main path's 80 M nonzeros
  at R = 10, serving's fold-in layout at R = 32, and the ``netflix-small``
  spec's skewed buckets at R = 8. It must show zero findings.
* ``--paper-scale``: the paper-netflix extents at R = 32 and the paper's
  function tensor (order 4, 5000 a mode) at R = 25. Its findings are
  recorded, not gated. The CUDA kernels keep only a bucket's
  ``block_rows`` output rows (and rows of x) in shared memory and gather
  factor rows from L2 and device memory, so the extents do not enter the
  shared-memory footprint, unlike the TPU kernels' VMEM-resident factors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.analysis.lint import Finding
from repro_torch.kernels.footprint import (KernelGeometry,
                                           estimate_footprint,
                                           smem_budget_bytes)

DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# the tile accumulators priced over each element type: float64 operands sum
# in float64 whatever the tile names, so they are priced once
ACCUMULATORS = {torch.float32: ("float32", "float64"),
                torch.bfloat16: ("float32", "float64"),
                torch.float64: ("float32",)}

# (label, dims, rank, COO capacity, bucket capacity at block_rows 8)
_PORT_LAYOUTS: Tuple[Tuple[str, Tuple[int, ...], int, int, int], ...] = (
    ("80M", (20_000, 20_000, 20_000), 10, 80_000_000, 32_608),
    ("fold-in", (1_024, 17_770, 2_182), 32, 204_800, 2_048),
    ("netflix-small", (150, 120, 40), 8, 40_000, 13_152),
)
_PAPER_LAYOUTS: Tuple[Tuple[str, Tuple[int, ...], int, int, int], ...] = (
    ("paper-netflix", (480_189, 17_770, 2_182), 32, 100_480_507, 1 << 20),
    ("paper-function", (5_000, 5_000, 5_000, 5_000), 25, 1 << 30, 1 << 20),
)


def _geometries(family: str, layouts, block_rows: int, dtype
                ) -> List[Tuple[str, KernelGeometry]]:
    out: List[Tuple[str, KernelGeometry]] = []
    for label, dims, rank, cap, bucket_cap in layouts:
        if family == "tttp":
            geom = KernelGeometry(nd=len(dims), rank=rank,
                                  factor_rows=tuple(dims), capacity=cap,
                                  block_rows=block_rows, dtype=dtype)
        else:
            # the bucketed kernels run over mode-0 buckets and gather the
            # other modes' factor rows
            geom = KernelGeometry(
                nd=len(dims), rank=rank, factor_rows=tuple(dims[1:]),
                capacity=bucket_cap, block_rows=block_rows,
                x_rows=dims[0] if family == "cg_matvec" else None,
                dtype=dtype)
        out.append((label, geom))
    return out


def run(paper_scale: bool = False) -> List[Finding]:
    """SP201 for each lattice tile of each family and element type that
    does not fit, at the tier's layouts, against the shared-memory budget
    of ``kernels.footprint.smem_budget_bytes`` (``REPRO_SMEM_KB``, which
    the CLI's ``--budget-mb`` sets, overrides it)."""
    from repro_torch.planner import tuner

    budget = smem_budget_bytes()
    layouts = _PAPER_LAYOUTS if paper_scale else _PORT_LAYOUTS
    findings: List[Finding] = []
    for family, lattice in sorted(tuner.LATTICES.items()):
        for base in lattice:
            for dtype in DTYPES:
                for accum in ACCUMULATORS[dtype]:
                    tile = dataclasses.replace(base, accum_dtype=accum)
                    for label, geom in _geometries(family, layouts,
                                                   tile.block_rows, dtype):
                        est = estimate_footprint(family, tile, geom,
                                                 budget=budget)
                        if not est.fits:
                            findings.append(Finding(
                                "footprint", 0, 0, "SP201",
                                f"[{label}, {dtype}, {accum} accumulator] "
                                f"lattice tile cannot run on the card: "
                                f"{est.format()}"))
    return findings


def check_fixture(mod) -> List[Finding]:
    """Fixture entry: a module declaring FAMILY, TILE (KernelTile kwargs)
    and GEOMETRY (KernelGeometry kwargs, ``dtype`` by name), optionally
    BUDGET_KB."""
    from repro_torch.kernels.tile import KernelTile

    tile = KernelTile(**mod.TILE)
    kw = dict(mod.GEOMETRY)
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = getattr(torch, kw["dtype"])
    geom = KernelGeometry(**kw)
    budget = getattr(mod, "BUDGET_KB", None)
    est = estimate_footprint(
        mod.FAMILY, tile, geom,
        budget=None if budget is None else int(budget * 1024))
    if est.fits:
        return []
    return [Finding("footprint", 0, 0, "SP201", f"[fixture] {est.format()}")]
