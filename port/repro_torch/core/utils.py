"""Small shared utilities: rounding, padding, index linearization and
tree helpers."""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.checkpoint.checkpointer import tree_leaves


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


def _strides(shape: Sequence[int]) -> list:
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    return strides


def linearize(indices: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Row-major linearization of an ``(..., ndim)`` int index tensor, in
    int64; raises if ``prod(shape)`` overflows it. Key comparisons use
    :func:`lex_sort_perm` instead, which has no such limit."""
    total = math.prod(int(s) for s in shape)
    if total > torch.iinfo(torch.int64).max:
        raise ValueError(f"linearize: prod(shape)={total} overflows int64")
    strides = torch.tensor(_strides(shape), dtype=torch.int64,
                           device=indices.device)
    return torch.sum(indices.long() * strides, dim=-1)


def delinearize(lin: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`linearize`: ``(..., ndim)`` int32 indices."""
    rem = lin.long()
    out = []
    for stride in _strides(shape):
        out.append((rem // stride).to(torch.int32))
        rem = rem % stride
    return torch.stack(out, dim=-1)


def lex_sort_perm(indices: torch.Tensor, mask: torch.Tensor,
                  cols: Sequence[int]) -> torch.Tensor:
    """Permutation sorting the rows of ``indices`` lexicographically by
    ``cols`` (the first most significant), rows where ``mask`` is false
    last: one stable sort per column, so no key can overflow."""
    perm = torch.arange(indices.shape[0], device=indices.device)
    for c in reversed(list(cols)):
        perm = perm[torch.sort(indices[perm, c], stable=True).indices]
    return perm[torch.sort((~mask[perm]).to(torch.uint8),
                           stable=True).indices]


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise row equality of (n, k) int tensors."""
    return torch.all(a == b, dim=-1)


def global_norm(tree) -> torch.Tensor:
    """2-norm over every tensor leaf of a nest, summed in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def param_count(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))
