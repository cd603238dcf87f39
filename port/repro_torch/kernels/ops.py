"""Wrappers that dispatch the three sparse kernels by the tensors' device.

A CUDA tensor goes to the hand-written kernel (``kernels.tttp``,
``kernels.mttkrp``, ``kernels.cg_matvec``), which launches or raises; a CPU
tensor goes to the plain PyTorch version in ``kernels.ref``. There is no
switch and no fallback between the two.

Results keep the reference's shapes: the kernels take float32 and
accumulate in float32 into padded outputs (``nb·block_rows`` rows for the
bucketed ones), which are sliced back to ``num_rows``. The reference also
padded the nonzero and capacity
axes to its Pallas tile multiples; the CUDA kernels mask their ragged edge
themselves, so those pads are not carried over.

Each kernel module counts its launches in a plain integer ``launches``;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import cg_matvec as kcg
from repro_torch.kernels import mttkrp as kmttkrp
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tttp as ktttp

_MODULES = {"tttp": ktttp, "mttkrp": kmttkrp, "cg_matvec": kcg}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def tttp_values(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]]
                ) -> torch.Tensor:
    """TTTP output values for a padded-COO SparseTensor. Vector factors are
    promoted to single-column matrices."""
    factors = [None if f is None else (f[:, None] if f.dim() == 1 else f)
               for f in factors]
    vals = st.values * st.mask
    if not _on_card(vals):
        return kref.tttp_ref(vals, st.indices, factors)
    return ktttp.tttp_cuda(vals, st.indices, factors)


def tttp(st: SparseTensor, factors) -> SparseTensor:
    return st.with_values(tttp_values(st, factors))


def mttkrp_bucketed(buckets, factors: Sequence[Optional[torch.Tensor]],
                    num_rows: Optional[int] = None) -> torch.Tensor:
    """All-at-once MTTKRP over ingest-time buckets; returns (num_rows, R)."""
    num_rows = num_rows or buckets.shape[buckets.mode]
    if not _on_card(buckets.values):
        out = kref.mttkrp_bucketed_ref(buckets.values, buckets.indices,
                                       buckets.local_row, factors,
                                       buckets.mode, buckets.block_rows)
        return out[:num_rows]
    return kmttkrp.mttkrp_cuda(buckets, factors)[:num_rows]


def cg_matvec_bucketed(buckets, factors: Sequence[Optional[torch.Tensor]],
                       x: torch.Tensor, num_rows: Optional[int] = None
                       ) -> torch.Tensor:
    """Fused implicit-CG Gram matvec; buckets hold the Ω indicator values."""
    num_rows = num_rows or buckets.shape[buckets.mode]
    if not _on_card(buckets.values):
        out = kref.cg_matvec_bucketed_ref(buckets.values, buckets.indices,
                                          buckets.local_row, factors, x,
                                          buckets.mode, buckets.block_rows)
        return out[:num_rows]
    return kcg.cg_matvec_cuda(buckets, factors, x)[:num_rows]
