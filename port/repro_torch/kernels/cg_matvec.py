"""Fused implicit-CG Gram matvec on the card: the wrapper of
``csrc/cg_matvec.cu``, which replaces the reference's
``kernels/cg_matvec.py:cg_matvec_pallas``.

One pass over the Ω buckets: the Khatri-Rao row ``KR[n]`` is formed once per
nonzero and used for both the TTTP half (``z[n] = ω[n]·⟨KR[n], x[i]⟩``) and
the MTTKRP half (``y[i] += z[n]·KR[n]``). ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp import check_buckets
from repro_torch.sparse.ccsr import RowBlockBuckets

# the kernel keeps KR[n] in registers, compiled for R up to this
MAX_RANK = 128

launches = 0


def cg_matvec_cuda(buckets: RowBlockBuckets,
                   factors: Sequence[Optional[torch.Tensor]],
                   x: torch.Tensor) -> torch.Tensor:
    """``buckets.values`` hold the weights ω (the Ω indicator for ALS).
    Returns (nb·block_rows, R) float32; callers slice to the true row
    count."""
    global launches
    nb, c = buckets.values.shape
    nd = buckets.indices.shape[-1]
    mode = buckets.mode
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    r = x.shape[1]
    if r > MAX_RANK:
        raise ValueError(f"R={r} > {MAX_RANK}: the fused matvec keeps the "
                         f"Khatri-Rao row in registers up to R={MAX_RANK}")
    dev = check_buckets(buckets, r)
    _build.check_operand("x", x, torch.float32, dev, (x.shape[0], r))
    table = [None if d == mode else f for d, f in enumerate(factors)]
    _build.check_factors(table, r, torch.float32, dev)
    out = torch.empty(nb * buckets.block_rows, r, dtype=torch.float32,
                      device=dev)
    if nb == 0:
        return out
    ptrs = _build.pointer_table(table)
    with torch.cuda.device(dev):
        _build.launch("repro_cg_matvec_bucketed_f32",
                      buckets.values.data_ptr(), buckets.indices.data_ptr(),
                      buckets.local_row.data_ptr(), buckets.valid.data_ptr(),
                      nb, c, nd, mode, ptrs, x.data_ptr(), r,
                      buckets.block_rows, out.data_ptr(), _build.THREADS,
                      torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
