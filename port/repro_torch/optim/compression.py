"""Gradient compression for bandwidth-bound all-reduces.

Error-feedback int8 quantised psum: the ranks agree on one scale (an
``all_reduce(MAX)`` of a scalar), quantise (gradient + error feedback) to
int8, sum the integer payload (an int32 ``all_reduce``, so P·127 cannot
overflow), and dequantise exactly with the shared scale. The local
quantisation error is carried to the next step (EF-SGD), which keeps
convergence. The nests of :func:`compressed_psum_tree` are lists, tuples
and dicts of tensors.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.checkpoint.checkpointer import tree_leaves, tree_map
from repro_torch.core import collectives as coll


def ef_state_init(grads_like) -> Any:
    """Zero error-feedback state, float32, shaped like ``grads_like``."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads_like)


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 psum of one tensor over ``group`` (None: the
    world). Returns (all-reduced gradient, new error-feedback state)."""
    comp = grad.to(torch.float32) + err
    # one shared scale: the int payloads then dequantise exactly
    scale = coll.all_reduce(comp.abs().max(), group, op="max") / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(comp / scale), -127, 127).to(torch.int8)
    new_err = comp - q.to(torch.float32) * scale
    summed = coll.all_reduce(q.to(torch.int32), group)
    return summed.to(torch.float32) * scale, new_err


def compressed_psum_tree(grads, err_tree, group=None):
    """:func:`compressed_psum` of every leaf; returns (sums, new errors) in
    ``grads``' structure."""
    pairs = [compressed_psum(g, e, group)
             for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    outs = iter([o for o, _ in pairs])
    errs = iter([e for _, e in pairs])
    return (tree_map(lambda _: next(outs), grads),
            tree_map(lambda _: next(errs), grads))
