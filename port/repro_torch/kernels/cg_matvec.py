"""Fused implicit-CG Gram matvec on the card: the wrapper of
``csrc/cg_matvec.cu``, which replaces the reference's
``kernels/cg_matvec.py:cg_matvec_pallas``.

One pass over the Ω buckets, with the kernel body the bucketed MTTKRP
shares (``kernels/mttkrp.py``): the Khatri-Rao row ``KR[n]`` is formed once
per nonzero and used for both the TTTP half (``z[n] = ω[n]·⟨KR[n],
x[i]⟩``, with the bucket's rows of ``x`` held in shared memory) and the
MTTKRP half (``y[i] += z[n]·KR[n]``). The factors and ``x`` reach the
kernel as zero-padded copies with a 16-byte row stride
(``kernels.mttkrp.pad_rows``); like the values, they are all float32, all
bfloat16 or all float64 (a bf16 launch sums in float32 and writes bf16, a
float64 launch sums in float64; a tile with ``accum_dtype="float64"`` sums
float32 or bf16 operands in float64). It takes R up to
``kernels.mttkrp.MAX_RANK`` and refuses a wider one:
``kernels.ops.cg_matvec_bucketed`` runs wider R as TTTP then MTTKRP. The
launch shape and accumulator are a ``kernels.tile.KernelTile``.
``launches`` counts the kernel's launches, ``launches_by_dtype`` splits
them by element type and accumulator, and ``last_launch`` holds the
(threads, per_thread) of the last one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp import check_buckets, launch_bucketed
from repro_torch.kernels.tile import DEFAULT_TILE, KernelTile
from repro_torch.sparse.ccsr import RowBlockBuckets

launches = 0
launches_by_dtype = dict.fromkeys(_build.VARIANT_NAMES, 0)
last_launch = None


def cg_matvec_cuda(buckets: RowBlockBuckets,
                   factors: Sequence[Optional[torch.Tensor]],
                   x: torch.Tensor,
                   tile: KernelTile = DEFAULT_TILE) -> torch.Tensor:
    """``buckets.values`` hold the weights ω (the Ω indicator for ALS);
    they, the factors and ``x`` share one element type, float32, bfloat16
    or float64. Returns (nb·block_rows, R) in that type; callers slice to the
    true row count."""
    global launches, last_launch
    r = x.shape[1]
    table = check_buckets(buckets, factors, r, x, tile)
    out = launch_bucketed("cg_matvec_bucketed", buckets, table, x, r, tile)
    if buckets.num_blocks:
        dt = buckets.values.dtype
        launches += 1
        launches_by_dtype[_build.variant_name(dt, tile.accumulator(dt))] += 1
        last_launch = (tile.threads, tile.per_thread)
    return out
