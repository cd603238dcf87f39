"""Redistribution of sparse and dense tensors between rank layouts (paper
Fig. 4): placing the nonzeros on a layout, replicating, the distributed
transpose with its shard-boundary rebalancing (a transposed tensor is no
longer sorted or balanced by its new leading mode) and the
order-preserving reshape.

The reference's global re-sort is XLA's distributed sort over the sharded
arrays. Here it is an ``all_gather`` of every rank's block (its valid and
padding slots alike), one ``lex_sort_perm`` of the whole, and the rank's
block of the sorted result: Θ(cap) memory on every rank, acceptable at the
sizes it runs at (``ROADMAP.md`` Queue C); a sample sort would cut that to
Θ(cap / P).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
from repro_torch.core.distributed import LOCAL, AxisCtx, DistLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.utils import lex_sort_perm


def shard_nonzeros(st: SparseTensor, layout: DistLayout) -> SparseTensor:
    """This rank's block of the nonzeros (the paper's distribution of the
    observed entries). The capacity must be a multiple of the data-axis
    size: ``data.synthetic.shuffle_and_pad(num_shards=)`` pads it."""
    return layout.shard(st)


def replicate(x: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank (a broadcast)."""
    return coll.broadcast(x, 0, group)


def _resorted(st: SparseTensor, ctx: AxisCtx) -> SparseTensor:
    """``st`` sorted by all modes (padding last) across the data axes: the
    gathered blocks sorted as one, then this rank's block kept."""
    if ctx.data is None:
        p = lex_sort_perm(st.indices, st.mask, range(st.ndim))
        return SparseTensor(st.indices[p], st.values[p], st.valid[p],
                            st.shape, st.nnz, sorted_mode=0)
    group = ctx.data_group
    idx = coll.all_gather(st.indices, group)
    vals = coll.all_gather(st.values, group)
    valid = coll.all_gather(st.valid.to(torch.uint8), group).bool()
    p = lex_sort_perm(idx, valid, range(st.ndim))
    lo = dist.get_rank(group) * st.cap
    keep = p[lo:lo + st.cap]
    return SparseTensor(idx[keep], vals[keep], valid[keep], st.shape,
                        st.nnz, sorted_mode=0)


def transpose_distributed(st: SparseTensor, perm: Sequence[int],
                          resort: bool = True,
                          ctx: AxisCtx = LOCAL) -> SparseTensor:
    """Distributed sparse transpose: permute the index columns, then
    (``resort``) sort globally by the new modes so that downstream CCSR
    views and shard balance hold, with the padding at the end. ``st`` is
    this rank's block under ``ctx``'s data axes (LOCAL: the whole)."""
    out = st.transpose(perm)
    return _resorted(out, ctx) if resort else out


def reshape_distributed(st: SparseTensor, new_shape: Sequence[int],
                        resort: bool = True,
                        ctx: AxisCtx = LOCAL) -> SparseTensor:
    """Distributed sparse reshape keeping the global row-major order (the
    paper notes that the order preservation makes it cheaper than a
    transpose): each rank reshapes its own block and nothing moves, so a
    tensor sorted by mode 0 stays sorted across the ranks' blocks."""
    out = st.reshape(new_shape)
    if resort:
        out = SparseTensor(out.indices, out.values, out.valid, out.shape,
                           out.nnz,
                           sorted_mode=0 if st.sorted_mode == 0 else None)
    return out


def reshard_dense(x: torch.Tensor, layout: DistLayout,
                  spec: Sequence) -> torch.Tensor:
    """This rank's block of the logical dense array ``x`` under ``layout``
    and ``spec`` (``None``, ``"data"`` or ``"model"`` per dim): Cyclops'
    redistribution of dense matrices between mappings, for an ``x`` every
    rank holds."""
    return layout.slice(x, spec)
