"""Execution context of the completion algorithms, LOCAL only for now.

The algorithms are written against an :class:`AxisCtx` so the same code can
later run over a process group; here every reduction over devices is the
identity. ``mttkrp_ctx`` routes straight to the bucketed MTTKRP kernel
through the tensor's cached CCSR buckets until the planner is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Single-device context: both psums are identities."""

    def psum_data(self, x):
        return x

    def psum_model(self, x):
        return x


LOCAL = AxisCtx()


def mttkrp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
               mode: int, ctx: AxisCtx = LOCAL,
               block_rows: int = 8) -> torch.Tensor:
    """Bucketed MTTKRP through ``st``'s cached CCSR buckets, psum over the
    data axes. Output (shape[mode], R)."""
    return ctx.psum_data(kops.mttkrp_bucketed(st.row_buckets(mode, block_rows),
                                              factors,
                                              num_rows=st.shape[mode]))


def rowdot_ctx(a: torch.Tensor, b: torch.Tensor,
               ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """Row-wise inner products of (rows, R) matrices."""
    return ctx.psum_model((a * b).sum(dim=-1))
