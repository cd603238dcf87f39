"""Stochastic gradient descent for tensor completion (paper §2.4, Listing 7).

Each sweep samples S observed entries (uniformly, with replacement), computes
the sampled gradient of every factor by MTTKRP on the sample and applies a
plain SGD update:

    s_ir = 2 Σ_{sample} v_jr w_kr (⟨u_i,v_j,w_k⟩ − t_n) · (m/S) + 2λ u_ir

The (m/S) factor unbiases the data term. The sample is drawn by
``torch.randint`` over the slots of the valid entries (found once per
tensor): the reference's probability-weighted ``jax.random.choice`` would
be ``torch.multinomial`` here, which takes at most 2^24 categories. Each
sweep's sample is a new tensor, so its MTTKRPs build one CCSR bucket
pattern per mode (a sort on the device). :func:`sgd_update` runs the
update on a sample the caller provides.

Under a data axis each shard samples its own nonzeros and scales by its
own valid count over S; the psum over the data axes then sums the
per-shard expectations. :func:`shard_seed` decorrelates the shards' draws
(the reference folds the flattened data-axis index into its key); a data
axis of size 1 keeps the caller's seed, so it reproduces the LOCAL draws.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.distributed import LOCAL, AxisCtx, mttkrp_ctx
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values


def shard_seed(seed: int, ctx: AxisCtx = LOCAL) -> int:
    """The seed of this data shard's sample: ``seed`` itself on one shard,
    else ``seed`` folded with the flattened data-axis index."""
    if ctx.data is None or ctx.data_size() <= 1:
        return seed
    from repro_torch.core.completion import fold_seed
    return fold_seed(seed, ctx.data_index())


def sample_entries(generator: torch.Generator, st: SparseTensor,
                   sample_size: int) -> SparseTensor:
    """Uniform with-replacement sample of the valid entries, as a tensor of
    ``sample_size`` entries. A tensor with no valid entry (a shard that is
    all padding) samples uniformly over its capacity and marks every
    sampled entry invalid, as the reference does."""
    pos = st.valid_positions()
    dev = st.device
    if pos.numel() > 0:
        pick = pos[torch.randint(0, pos.numel(), (sample_size,),
                                 generator=generator, device=dev)]
        valid = torch.ones(sample_size, dtype=torch.bool, device=dev)
    else:
        pick = torch.randint(0, st.cap, (sample_size,), generator=generator,
                             device=dev)
        valid = torch.zeros(sample_size, dtype=torch.bool, device=dev)
    return SparseTensor(st.indices[pick], st.values[pick], valid, st.shape,
                        nnz=sample_size)


def sgd_update(st: SparseTensor, sample: SparseTensor,
               factors: Sequence[torch.Tensor], lam: float, lr: float,
               ctx: AxisCtx = LOCAL, block_rows: int = 8
               ) -> List[torch.Tensor]:
    """The update of one sweep on ``sample`` (drawn from ``st``): each
    factor in turn, from one TTTP for the model values and one bucketed
    MTTKRP on the scaled residual."""
    scale = st.valid.sum().to(sample.values.dtype) / sample.cap
    fs = list(factors)
    for d in range(st.ndim):
        model = ctx.psum_model(multilinear_values(sample, fs))
        # the (valid / S) unbiasing folded into the residual values:
        # MTTKRP is linear in them
        resid = sample.with_values((model - sample.values) * scale)
        g_fs = list(fs)
        g_fs[d] = None
        grad = mttkrp_ctx(resid, g_fs, d, ctx, block_rows)
        grad = 2.0 * grad + 2.0 * lam * fs[d]
        fs[d] = fs[d] - lr * grad
    return fs


def sgd_sweep(generator: torch.Generator, st: SparseTensor,
              factors: Sequence[torch.Tensor], lam: float, lr: float,
              sample_size: int, ctx: AxisCtx = LOCAL,
              block_rows: int = 8) -> List[torch.Tensor]:
    """One SGD sweep: sample once, update every factor matrix."""
    sample = sample_entries(generator, st, sample_size)
    return sgd_update(st, sample, factors, lam, lr, ctx, block_rows)
