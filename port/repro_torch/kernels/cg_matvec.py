"""Fused implicit-CG Gram matvec on the card: the wrapper of
``csrc/cg_matvec.cu``, which replaces the reference's
``kernels/cg_matvec.py:cg_matvec_pallas``.

One pass over the Ω buckets, with the kernel body the bucketed MTTKRP
shares (``kernels/mttkrp.py``): the Khatri-Rao row ``KR[n]`` is formed once
per nonzero and used for both the TTTP half (``z[n] = ω[n]·⟨KR[n],
x[i]⟩``, with the bucket's rows of ``x`` held in shared memory) and the
MTTKRP half (``y[i] += z[n]·KR[n]``). The factors and ``x`` reach the
kernel as zero-padded copies with a 16-byte row stride
(``kernels.mttkrp.pad_rows``). ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.mttkrp import launch_bucketed
from repro_torch.sparse.ccsr import RowBlockBuckets

launches = 0


def cg_matvec_cuda(buckets: RowBlockBuckets,
                   factors: Sequence[Optional[torch.Tensor]],
                   x: torch.Tensor) -> torch.Tensor:
    """``buckets.values`` hold the weights ω (the Ω indicator for ALS).
    Returns (nb·block_rows, R) float32; callers slice to the true row
    count."""
    global launches
    out = launch_bucketed("repro_cg_matvec_bucketed_f32", buckets, factors,
                          x, x.shape[1])
    if buckets.num_blocks:
        launches += 1
    return out
