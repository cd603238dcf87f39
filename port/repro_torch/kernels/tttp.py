"""TTTP on the card: the wrapper of ``csrc/tttp.cu``, which replaces the
reference's ``kernels/tttp.py:tttp_pallas``.

``out[n] = valid[n] ? values[n] · Σ_r Π_{d present} A_d[indices[n, d], r]
: 0``, no scatter. The kernel reads the valid mask itself and gathers factor
rows as 16-byte loads, so the wrapper hands it zero-padded copies of the
factors with a row stride of 16 bytes, 4 floats, 8 bf16 values or 2
doubles (``kernels.mttkrp.pad_rows``). It takes any R, and values and
factors of one element type, float32, bfloat16 or float64: a bf16 launch
reads bf16, sums in float32 and writes bf16; a float64 launch sums and
writes float64. The launch shape (threads per CTA, nonzeros per thread) and
the accumulator are a ``kernels.tile.KernelTile``: a tile with
``accum_dtype="float64"`` sums float32 or bf16 operands in float64 and
writes their type. ``launches`` counts the kernel's launches,
``launches_by_dtype`` splits them by element type and accumulator
(``_build.variant_name``), and ``last_launch`` holds the (threads,
per_thread) of the last one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp import pad_rows, padded_width
from repro_torch.kernels.tile import DEFAULT_TILE, KernelTile

launches = 0
launches_by_dtype = dict.fromkeys(_build.VARIANT_NAMES, 0)
last_launch = None


def tttp_cuda(values: torch.Tensor, indices: torch.Tensor,
              valid: torch.Tensor,
              factors: Sequence[Optional[torch.Tensor]],
              tile: KernelTile = DEFAULT_TILE) -> torch.Tensor:
    """``values (m,)``, ``indices (m, nd)`` int32, ``valid (m,)`` bool,
    ``factors[d]`` ``(shape[d], R)`` or None, all contiguous on one CUDA
    device, values and factors of one element type (float32, bfloat16 or
    float64), summed in ``tile.accumulator`` of it.
    Returns (m,) in that type, 0 where ``valid`` is false."""
    global launches, last_launch
    dev = values.device
    m, nd = indices.shape
    if len(factors) != nd:
        raise ValueError(f"{len(factors)} factors for an order-{nd} tensor")
    present = [f for f in factors if f is not None]
    if not present:
        raise ValueError("TTTP requires at least one factor")
    if nd > 8:
        raise ValueError(f"order {nd} > 8: the kernel takes at most 8 modes")
    r = present[0].shape[1]
    dt = _build.operand_dtype(
        values=values, **{f"factor {d}": f for d, f in enumerate(factors)})
    acc = tile.accumulator(dt)
    _build.check_operand("values", values, dt, dev, (m,))
    _build.check_operand("indices", indices, torch.int32, dev)
    _build.check_operand("valid", valid, torch.bool, dev, (m,))
    _build.check_factors(factors, r, dt, dev)
    out = torch.empty(m, dtype=dt, device=dev)
    if m == 0:
        return out
    padded = [None if f is None else pad_rows(f) for f in factors]
    table = _build.pointer_table(padded)
    with torch.cuda.device(dev):
        _build.launch(_build.entry("tttp", dt, acc), values.data_ptr(),
                      indices.data_ptr(), valid.data_ptr(), m, nd, table, r,
                      padded_width(r, dt), out.data_ptr(), tile.threads,
                      tile.per_thread,
                      torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    launches_by_dtype[_build.variant_name(dt, acc)] += 1
    last_launch = (tile.threads, tile.per_thread)
    return out
