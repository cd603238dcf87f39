"""Execution context of the completion algorithms, LOCAL only for now.

The algorithms are written against an :class:`AxisCtx` so the same code can
later run over a process group; here every reduction over devices is the
identity. ``tttp_ctx``, ``mttkrp_ctx`` and ``reduce_mode_ctx`` are shims
over the planner (``repro_torch.planner``), as in the reference: the
contraction is classified, planned (cached on its static signature) and
dispatched, and ``path`` forces a candidate.

One departure: ``path=None`` is the paper's all-at-once schedule, pinned
(``all_at_once`` for TTTP and MTTKRP: the TTTP kernel and the bucketed
MTTKRP kernel over the tensor's cached view; ``segment`` for the
reduction). The reference's ``None`` asks the §5.3 cost model, which on
small, fairly dense tensors ranks the pairwise KR-first MTTKRP first and so
takes the solvers off the kernel, and changes their summation order, at
test sizes; at the sizes the kernel is for (``chip_smoke.py``'s 80 M
nonzeros) it ranks ``all_at_once`` first as well.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Single-device context: both psums are identities, every axis has
    size 1 and there is no model axis. (The reference names the mesh axes of
    a ``shard_map`` region here; distribution is ``ROADMAP.md`` Queue A
    item 4.)"""

    model = None

    def psum_data(self, x):
        return x

    def psum_model(self, x):
        return x

    def data_size(self) -> int:
        return 1

    def model_size(self) -> int:
        return 1


LOCAL = AxisCtx()


def planner_config(block_rows: Optional[int] = None):
    """The process-wide ``PlannerConfig`` at bucket granularity
    ``block_rows`` (None keeps the default's)."""
    from repro_torch.planner.config import default_config
    cfg = default_config()
    if block_rows is None or block_rows == cfg.block_rows:
        return cfg
    return dataclasses.replace(cfg, block_rows=block_rows)


def tttp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
             ctx: AxisCtx = LOCAL, path: Optional[str] = None) -> SparseTensor:
    """TTTP under ``ctx`` through the planner; the psum over the model axis
    adds the partial products of column-sliced factors (inside dispatch).
    ``path`` forces a planner candidate (None: ``all_at_once``)."""
    from repro_torch.planner import planned_tttp
    return planned_tttp(st, factors, path=path or "all_at_once", ctx=ctx)


def mttkrp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
               mode: int, ctx: AxisCtx = LOCAL,
               block_rows: Optional[int] = None,
               path: Optional[str] = None) -> torch.Tensor:
    """Classic MTTKRP under ``ctx`` through the planner, psum over the data
    axes. ``block_rows`` is the bucket granularity of the cached view the
    bucketed kernel reads (None: the planner config's). ``path`` forces a
    planner candidate (None: ``all_at_once``, the bucketed kernel).
    Output (shape[mode], R)."""
    from repro_torch.planner import planned_mttkrp
    return planned_mttkrp(st, factors, mode, path=path or "all_at_once",
                          ctx=ctx, config=planner_config(block_rows))


def rowdot_ctx(a: torch.Tensor, b: torch.Tensor,
               ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """Row-wise inner products of (rows, R) matrices."""
    return ctx.psum_model((a * b).sum(dim=-1))


def reduce_mode_ctx(st: SparseTensor, mode: int, ctx: AxisCtx = LOCAL,
                    path: Optional[str] = None) -> torch.Tensor:
    """``einsum('ijk->i')``-style reduction of the valid entries onto
    ``mode`` through the planner (None: ``segment``, a segment sum by
    ``index_add_``), psum over the data axes."""
    from repro_torch.planner import planned_reduce
    return planned_reduce(st, (mode,), path=path or "segment", ctx=ctx)


def sqnorm_ctx(a: torch.Tensor, ctx: AxisCtx = LOCAL) -> torch.Tensor:
    return ctx.psum_model(torch.sum(torch.square(a)))
