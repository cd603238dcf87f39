"""TTTP on the card: the wrapper of ``csrc/tttp.cu``, which replaces the
reference's ``kernels/tttp.py:tttp_pallas``.

``out[n] = values[n] · Σ_r Π_{d present} A_d[indices[n, d], r]``, one thread
per nonzero, no scatter. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

launches = 0


def tttp_cuda(values: torch.Tensor, indices: torch.Tensor,
              factors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """``values (m,)`` float32, ``indices (m, nd)`` int32, ``factors[d]``
    ``(shape[d], R)`` float32 or None, all contiguous on one CUDA device.
    Returns (m,) float32."""
    global launches
    dev = values.device
    m, nd = indices.shape
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    present = [f for f in factors if f is not None]
    if not present:
        raise ValueError("TTTP requires at least one factor")
    r = present[0].shape[1]
    _build.check_operand("values", values, torch.float32, dev, (m,))
    _build.check_operand("indices", indices, torch.int32, dev)
    _build.check_factors(factors, r, torch.float32, dev)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    table = _build.pointer_table(factors)
    with torch.cuda.device(dev):
        _build.launch("repro_tttp_f32", values.data_ptr(), indices.data_ptr(),
                      m, nd, table, r, out.data_ptr(), _build.THREADS,
                      torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
