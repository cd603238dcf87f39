"""The in-bucket scatter primitive.

:func:`scatter_rows` is the plain PyTorch form of the in-bucket scatter-add
with both of the reference's schedules (one-hot product and segmented
cumulative sum). The plain versions in ``kernels.ref`` accumulate through
it; the CUDA kernels share their own form of it, ``csrc/scatter_rows.cuh``.

The reference's ``KernelTile`` and per-family tile table are not carried
over: the CUDA kernels take one launch shape (``kernels._build.THREADS``)
until a tuner is ported to choose among others.
"""
from __future__ import annotations

import torch

_SCHEDULES = ("onehot", "segmented")


def scatter_rows(prod: torch.Tensor, key: torch.Tensor, block_rows: int,
                 schedule: str, acc_dtype: torch.dtype) -> torch.Tensor:
    """Scatter-add ``prod`` (..., C, R) rows into (..., block_rows, R) rows
    by ``key`` (..., C); leading dimensions are independent buckets.

    Slots whose key is not in ``[0, block_rows)`` add nothing. The one-hot
    schedule takes keys in any order. The segmented schedule needs ``key``
    non-decreasing with padding slots mapped past the valid range
    (``key == block_rows``): callers build
    ``key = where(valid, local_row, block_rows)``. Monotonicity is what lets
    it read "rows with key ≤ i" as a prefix of the cumulative sum."""
    rows = torch.arange(block_rows, device=key.device, dtype=key.dtype)
    if schedule == "onehot":
        onehot = (key[..., None, :] == rows[:, None]).to(acc_dtype)
        return onehot @ prod.to(acc_dtype)
    if schedule != "segmented":
        raise ValueError(f"scatter schedule {schedule!r} not in {_SCHEDULES}")
    csum = torch.cumsum(prod.to(acc_dtype), dim=-2)          # (..., C, R)
    ends = (key[..., None, :] <= rows[:, None]).sum(dim=-1)  # (..., block_rows)
    last = torch.clamp(ends - 1, min=0)[..., None].expand(
        *ends.shape, csum.shape[-1])
    e = torch.where((ends > 0)[..., None], torch.gather(csum, -2, last), 0)
    prev = torch.cat([torch.zeros_like(e[..., :1, :]), e[..., :-1, :]],
                     dim=-2)
    return e - prev
