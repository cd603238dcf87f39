"""Completion solvers: implicit-CG ALS (paper §2.2), CCD++ (§2.3), SGD
(§2.4), first-order GCP and generalized Gauss-Newton for any loss, and
:func:`make_step`, the sweep of one of them by name."""
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import losses as LOSS
from repro_torch.core.completion.als import (als_sweep, als_sweep_explicit,
                                             batched_cg, batched_pcg)
from repro_torch.core.completion.ccd import (ccd_sweep, ccd_sweep_tttp,
                                             residual_values)
from repro_torch.core.completion.gauss_newton import (GGNState, ggn_init,
                                                      ggn_sweep)
from repro_torch.core.completion.gcp import gcp_adam_init, gcp_step
from repro_torch.core.completion.sgd import sgd_sweep, shard_seed
from repro_torch.core.distributed import LOCAL, AxisCtx
from repro_torch.core.sparse_tensor import SparseTensor

__all__ = ["als_sweep", "als_sweep_explicit", "batched_cg", "batched_pcg",
           "ccd_sweep", "ccd_sweep_tttp", "sgd_sweep", "gcp_step",
           "gcp_adam_init", "GGNState", "ggn_init", "ggn_sweep", "fold_seed",
           "make_step"]


def fold_seed(seed: int, n: int) -> int:
    """A seed made from ``seed`` and ``n`` alone (as ``jax.random.fold_in``
    makes a key): SGD draws sweep ``n``'s sample from it, so a resumed run
    draws what an uninterrupted one would."""
    return int(np.random.SeedSequence([seed, n]).generate_state(
        1, np.uint64)[0])


def make_step(algorithm: str, st: SparseTensor, omega: SparseTensor,
              factors: Sequence[torch.Tensor], *, lam: float,
              block_rows: int, loss: str = "quadratic", cg_tol: float = 1e-4,
              cg_iters: int = 20, matvec_path: str = "fused",
              lr: float = 1e-3, sample_rate: float = 0.1,
              damping: float = 1e-5, seed: int = 0,
              ctx: AxisCtx = LOCAL, nnz: Optional[int] = None
              ) -> Tuple[object, Callable, Callable]:
    """``(state0, step, get_factors)`` of ``algorithm`` (``als``, ``ccd``,
    ``ccd_tttp``, ``sgd``, ``gcp`` or ``ggn``) from ``factors``:
    ``step(i, state)`` runs sweep ``i`` and ``get_factors(state)`` reads the
    factors out of a state. ``loss`` (a name in ``core.losses.LOSSES``) is
    the one ``gcp`` and ``ggn`` lower; SGD draws sweep ``i``'s sample from
    ``fold_seed(seed, i)`` (on a data shard, ``sgd.shard_seed`` of it), of
    ``max(1024, sample_rate · nnz)`` entries (``nnz``: the global count,
    default ``st.nnz``). Every sweep runs under ``ctx``: ``st``, ``omega``
    and ``factors`` are then this rank's shard and column slices."""
    fn = LOSS.LOSSES[loss]
    if algorithm == "als":
        return (list(factors),
                lambda i, fs: als_sweep(st, omega, fs, lam, cg_tol=cg_tol,
                                        cg_iters=cg_iters, ctx=ctx,
                                        matvec_path=matvec_path,
                                        block_rows=block_rows),
                list)
    if algorithm in ("ccd", "ccd_tttp"):
        sweep = ccd_sweep if algorithm == "ccd" else ccd_sweep_tttp
        return ((list(factors), residual_values(st, factors, ctx)),
                lambda i, s: sweep(st, s[0], s[1], lam, ctx=ctx),
                lambda s: list(s[0]))
    if algorithm == "sgd":
        gen = torch.Generator(device=st.device)
        sample = max(1024, int(sample_rate * (nnz or st.nnz)))
        return (list(factors),
                lambda i, fs: sgd_sweep(
                    gen.manual_seed(shard_seed(fold_seed(seed, i), ctx)),
                    st, fs, lam, lr, sample, ctx=ctx, block_rows=block_rows),
                list)
    if algorithm == "gcp":
        return ((list(factors), gcp_adam_init(factors)),
                lambda i, s: gcp_step(st, s[0], fn, lam, lr, s[1], ctx=ctx,
                                      block_rows=block_rows),
                lambda s: list(s[0]))
    if algorithm == "ggn":
        return (ggn_init(factors, damping=damping),
                lambda i, s: ggn_sweep(st, s, fn, lam, cg_tol=cg_tol,
                                       cg_iters=cg_iters, ctx=ctx,
                                       matvec_path=matvec_path,
                                       block_rows=block_rows),
                lambda s: list(s.factors))
    raise ValueError(f"unknown algorithm {algorithm!r}")
