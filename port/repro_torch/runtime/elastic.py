"""Elastic scaling: re-plan a checkpointed job for another rank count.

Checkpoints are layout-independent logical arrays (``repro_torch
.checkpoint``), so elasticity is re-partitioning at restore:

* dense state (factor matrices, optimiser moments): each rank slices its
  block of every leaf for the new layout;
* sparse datasets: the nonzero shards are re-balanced to the new shard
  count (capacity padded to its multiple, entries re-shuffled so each new
  shard is equally loaded), then each rank keeps its block.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import tree_map_with_path
from repro_torch.core.distributed import DistLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data.synthetic import shuffle_and_pad


def replan_sparse(st: SparseTensor, generator: torch.Generator,
                  layout: Optional[DistLayout] = None) -> SparseTensor:
    """Re-balance a sparse dataset for ``layout`` (None: one device) and
    keep this rank's block."""
    out = shuffle_and_pad(st, generator,
                          1 if layout is None else layout.data_size)
    return out if layout is None else layout.shard(out)


def replan_dense(tree, layout: Optional[DistLayout],
                 spec_fn: Optional[Callable] = None):
    """Each tensor leaf of ``tree`` sliced for ``layout``:
    ``spec_fn(path, leaf)`` gives the leaf's spec (``None``, ``"data"`` or
    ``"model"`` per dim; default: replicated)."""
    if layout is None:
        return tree
    return tree_map_with_path(
        lambda path, leaf: layout.slice(leaf, spec_fn(path, leaf))
        if spec_fn is not None and isinstance(leaf, torch.Tensor) else leaf,
        tree)
