"""Small shared utilities: rounding and padding."""
from __future__ import annotations

import torch


def round_up(x: int, mult: int) -> int:
    """Round ``x`` up to the nearest multiple of ``mult``."""
    return ((x + mult - 1) // mult) * mult


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def pad_axis(x: torch.Tensor, size: int, axis: int = 0,
             value=0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to ``size`` with ``value``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} of size {cur} down to {size}")
    fill_shape = list(x.shape)
    fill_shape[axis] = size - cur
    fill = torch.full(fill_shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)
