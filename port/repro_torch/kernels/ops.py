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
A wrapper called while a CUDA graph captures launches nothing: the graph
launches its kernels at each replay. :func:`recorded_launches` takes such
calls back out of the counts and hands them to the caller, which adds them
at every replay with :func:`add_launches`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence

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


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the counts: what one
    replay of a captured graph launched."""
    for name, n in counts.items():
        _MODULES[name].launches += n


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: on exit the counts are what they were on
    entry, and the dict yielded holds the launches the wrappers recorded
    inside, which the graph makes at each replay."""
    before = launch_counts()
    held: Dict[str, int] = {}
    try:
        yield held
    finally:
        for name, n in launch_counts().items():
            held[name] = n - before[name]
            _MODULES[name].launches = before[name]


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _tttp(values: torch.Tensor, indices: torch.Tensor, valid: torch.Tensor,
          factors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """TTTP over flat (m,) slots, 0 where ``valid`` is false. Vector factors
    are promoted to single-column matrices."""
    factors = [None if f is None else (f[:, None] if f.dim() == 1 else f)
               for f in factors]
    if not _on_card(values):
        return kref.tttp_ref(values, indices, valid, factors)
    return ktttp.tttp_cuda(values, indices, valid, factors)


def tttp_values(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]]
                ) -> torch.Tensor:
    """TTTP output values for a padded-COO SparseTensor, 0 on padding."""
    return _tttp(st.values, st.indices, st.valid, factors)


def tttp_bucket_values(buckets, factors: Sequence[Optional[torch.Tensor]]
                       ) -> torch.Tensor:
    """TTTP over a CCSR bucket view (``RowBlockBuckets``): its nb·C slots
    flattened, so the same kernel runs on them. Returns (nb, C) in bucket
    order, 0 on padding slots: the values of a bucket view of the COO
    result, with no gather through the pattern."""
    nb, c, nd = buckets.indices.shape
    out = _tttp(buckets.values.reshape(nb * c),
                buckets.indices.reshape(nb * c, nd),
                buckets.valid.reshape(nb * c), factors)
    return out.view(nb, c)


def tttp(st: SparseTensor, factors) -> SparseTensor:
    return st.with_values(tttp_values(st, factors))


def mttkrp_bucketed(buckets, factors: Sequence[Optional[torch.Tensor]],
                    num_rows: Optional[int] = None) -> torch.Tensor:
    """All-at-once MTTKRP over ingest-time buckets; returns (num_rows, R).
    On the card any R: one launch per column tile of at most
    ``kernels.mttkrp.MAX_RANK`` columns."""
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
    """Implicit-CG Gram matvec (paper eq. 3) over the Ω buckets (their
    values are the weights ω), routed by rank on both devices:

    - R ≤ ``kernels.mttkrp.MAX_RANK``: one fused pass (the fused CG-matvec
      kernel on the card);
    - wider R: TTTP over the same bucket view, ``z = ω·⟨KR, x_i⟩``
      (:func:`tttp_bucket_values`), then the bucketed MTTKRP with values z,
      one launch per column tile on the card. The fused kernel keeps a
      Khatri-Rao row and x's rows resident, which it cannot at that width."""
    num_rows = num_rows or buckets.shape[buckets.mode]
    mode = buckets.mode
    if x.shape[1] > kmttkrp.MAX_RANK:
        fs = list(factors)
        fs[mode] = x
        z = tttp_bucket_values(buckets, fs)
        fs[mode] = None
        return mttkrp_bucketed(dataclasses.replace(buckets, values=z), fs,
                               num_rows)
    if not _on_card(buckets.values):
        out = kref.cg_matvec_bucketed_ref(buckets.values, buckets.indices,
                                          buckets.local_row, factors, x,
                                          mode, buckets.block_rows)
        return out[:num_rows]
    return kcg.cg_matvec_cuda(buckets, factors, x)[:num_rows]
