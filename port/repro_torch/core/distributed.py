"""Execution context of the completion algorithms, LOCAL only for now.

The algorithms are written against an :class:`AxisCtx` so the same code can
later run over a process group; here every reduction over devices is the
identity. ``tttp_ctx`` and ``mttkrp_ctx`` route straight to the TTTP and
bucketed MTTKRP kernels (the latter through the tensor's cached CCSR
buckets) until the planner is ported; ``reduce_mode_ctx`` is a segment sum
by ``index_add_``, as the reference's planned reduction is plain ``jnp``.
The reference's ``path=`` forces a planner candidate: here any ``path``
other than ``None`` raises, never ignored.
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


def no_planner_path(path: Optional[str]) -> None:
    """Raise on a ``path`` that would force a planner candidate."""
    if path is not None:
        raise NotImplementedError(
            f"path={path!r} forces a planner candidate; the planner is not "
            f"ported yet")


def tttp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
             ctx: AxisCtx = LOCAL, path: Optional[str] = None) -> SparseTensor:
    """TTTP under ``ctx``, straight to the TTTP kernel; the psum over the
    model axis adds the partial products of column-sliced factors (the
    values scale every partial alike)."""
    no_planner_path(path)
    return st.with_values(ctx.psum_model(kops.tttp_values(st, factors)))


def mttkrp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
               mode: int, ctx: AxisCtx = LOCAL, block_rows: int = 8,
               path: Optional[str] = None) -> torch.Tensor:
    """Bucketed MTTKRP through ``st``'s cached CCSR buckets, psum over the
    data axes. Output (shape[mode], R)."""
    no_planner_path(path)
    return ctx.psum_data(kops.mttkrp_bucketed(st.row_buckets(mode, block_rows),
                                              factors,
                                              num_rows=st.shape[mode]))


def rowdot_ctx(a: torch.Tensor, b: torch.Tensor,
               ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """Row-wise inner products of (rows, R) matrices."""
    return ctx.psum_model((a * b).sum(dim=-1))


def reduce_mode_ctx(st: SparseTensor, mode: int,
                    ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """``einsum('ijk->i')``-style reduction of the valid entries onto
    ``mode``: a segment sum by ``index_add_``, psum over the data axes."""
    out = torch.zeros(st.shape[mode], dtype=st.values.dtype,
                      device=st.device)
    return ctx.psum_data(out.index_add_(0, st.indices[:, mode].long(),
                                        st.masked_values()))


def sqnorm_ctx(a: torch.Tensor, ctx: AxisCtx = LOCAL) -> torch.Tensor:
    return ctx.psum_model(torch.sum(torch.square(a)))
