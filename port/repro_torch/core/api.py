"""NumPy-style user-facing facade, the Cyclops-Python-interface analogue.

Mirrors the paper's Listings 1–7 surface: tensor constructors, einsum over
mixed sparse/dense operands (the contraction patterns of tensor
completion), and TTTP. Every constructor takes a ``device`` (default
``cuda``); pass ``device="cpu"`` to run the plain PyTorch versions.

    import torch
    import repro_torch.core.api as ctf
    g = torch.Generator(device="cuda").manual_seed(0)
    T = ctf.random_sparse((I, J, K), nnz, g)       # fill_sp_random
    S = ctf.TTTP(T, [U, V, W])                     # Listing 3
    y = ctf.einsum("ijk,jr,kr->ir", T, V, W)       # MTTKRP
    a = ctf.einsum("ijk->i", S)                    # sparse reduction

``einsum`` and ``TTTP`` route through ``repro_torch.planner``: the
expression is parsed into a typed contraction IR, the candidate execution
paths (all-at-once, bucketed, pairwise T-first / KR-first, H-sliced, dense
fallback, …) are ranked by the paper's §5.3 cost model, and the winner is
dispatched onto the CUDA kernels or the plain contractions. Plans are cached
on the static call signature. ``path=`` forces a candidate; ``plan=`` reuses
a caller-held plan; ``autotune=True`` times the candidates once and pins the
measured winner.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch import planner as _planner
from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor

Tensor = Union[SparseTensor, torch.Tensor]


def tensor(shape, sp: bool = False, cap: Optional[int] = None,
           device="cuda") -> Tensor:
    """ctf.tensor analogue on ``device``; a sparse tensor starts empty with
    capacity ``cap``."""
    if not sp:
        return torch.zeros(tuple(shape), device=device)
    cap = cap or 1
    return SparseTensor(torch.zeros((cap, len(shape)), dtype=torch.int32,
                                    device=device),
                        torch.zeros((cap,), device=device),
                        torch.zeros((cap,), dtype=torch.bool, device=device),
                        tuple(int(s) for s in shape), nnz=0)


def random_sparse(shape, nnz: int, generator: Optional[torch.Generator] = None,
                  cap: Optional[int] = None, device="cuda") -> SparseTensor:
    """Uniform-random sparse tensor (``fill_sp_random``) drawn from
    ``generator``, which fixes the device; without one, a fresh generator
    on ``device`` seeded 0."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return SparseTensor.random(generator, shape, nnz, cap=cap)


def ones(shape, device="cuda") -> torch.Tensor:
    return torch.ones(tuple(shape), device=device)


def eye(n: int, device="cuda") -> torch.Tensor:
    return torch.eye(n, device=device)


def TTTP(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
         path: Optional[str] = None, autotune: bool = False,
         ctx: AxisCtx = LOCAL) -> SparseTensor:
    """Paper Listing 3; accepts None entries and vector factors."""
    return _planner.planned_tttp(st, factors, path=path, autotune=autotune,
                                 ctx=ctx)


def einsum(expr: str, *operands, path: Optional[str] = None,
           plan: Optional["_planner.Plan"] = None, autotune: bool = False,
           ctx: AxisCtx = LOCAL, device="cuda") -> Tensor:
    """Einstein summation over mixed sparse/dense operands.

    Supported sparse patterns (any tensor order, one sparse operand):
      * pure-dense expressions, handed to ``torch.einsum`` (lists and
        scalars become tensors on ``device``);
      * sparse reductions over arbitrary mode subsets:  "ijkl->li", "ijk->"
      * TTM (one dense matrix, any output order):       "ijk,kr->ijr"
      * MTTKRP family (classic and partial/multi-out):  "ijk,jr,kr->ir",
                                                        "ijkl,kr,lr->ijr"
      * TTTP / SDDMM (sampled multilinear, sparse out): "ijk,ir,jr,kr->ijk"
      * the weighted Gram matvec (paper eq. 3):  "ijk,jr,kr,iy,jy,ky->ir"

    ``path=`` forces one of the plan's candidate paths (see
    ``repro_torch.planner.candidate_paths``); by default the cost model
    picks.
    """
    return _planner.planned_einsum(expr, *operands, path=path, plan=plan,
                                   autotune=autotune, ctx=ctx, device=device)


def plan(expr: str, *operands: Tensor, path: Optional[str] = None,
         autotune: bool = False, ctx: AxisCtx = LOCAL) -> "_planner.Plan":
    """The plan ``einsum`` would use for this call (kind, chosen path,
    ranking)."""
    return _planner.plan_contraction(expr, operands, path=path,
                                     autotune=autotune, ctx=ctx)
