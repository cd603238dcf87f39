"""Generalized-loss tensor completion (GCP), first order.

Minimizes  Σ_{n∈Ω} ℓ(t_n, m_n) + λ Σ_d ‖A_d‖²  for any elementwise loss
(``repro_torch.core.losses``). The gradient with respect to factor d is

    ∇_{A_d} = MTTKRP(Ω-pattern tensor with values ∂ℓ/∂m |_n, factors≠d)
              + 2λ A_d

— the paper's kernels with the loss gradient in place of the residual: the
model values from the TTTP kernel, each gradient from the bucketed MTTKRP
kernel. Optimized by plain GD or Adam, full batch. Adam's step count stays a
0-d integer tensor on the device, so a step needs no host synchronisation.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import LOCAL, AxisCtx, mttkrp_ctx
from repro_torch.core.losses import Loss
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values


class AdamState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor  # () int32, on the factors' device


def gcp_adam_init(factors: Sequence[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros_like(f) for f in factors],
                     [torch.zeros_like(f) for f in factors],
                     torch.zeros((), dtype=torch.int32,
                                 device=factors[0].device))


def gcp_loss(st: SparseTensor, factors: Sequence[torch.Tensor], loss: Loss,
             lam: float, ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """The objective, a 0-d tensor on the device. Under a model axis the
    regulariser of the column slices is psum'd over it (the reference sums
    the local slices only, so its ranks would each see another objective
    and could accept different steps)."""
    model = ctx.psum_model(multilinear_values(st, list(factors)))
    data = ctx.psum_data(torch.sum(torch.where(
        st.mask, loss.value(st.values, model), 0.0)))
    reg = lam * ctx.psum_model(sum(torch.sum(torch.square(f))
                                   for f in factors))
    return data + reg


def gcp_gradients(st: SparseTensor, factors: Sequence[torch.Tensor],
                  loss: Loss, lam: float, ctx: AxisCtx = LOCAL,
                  mttkrp_path: Optional[str] = None,
                  block_rows: int = 8) -> List[torch.Tensor]:
    """Per-factor gradients: one TTTP for the model values, one MTTKRP per
    mode on the loss gradient (the bucketed kernel unless ``mttkrp_path``
    forces a planner candidate)."""
    model = ctx.psum_model(multilinear_values(st, list(factors)))
    g_st = st.with_values(torch.where(st.mask, loss.grad(st.values, model),
                                      0.0))
    grads = []
    for d in range(st.ndim):
        fs = list(factors)
        fs[d] = None
        grads.append(mttkrp_ctx(g_st, fs, d, ctx, block_rows,
                                path=mttkrp_path)
                     + 2.0 * lam * factors[d])
    return grads


def gcp_step(st: SparseTensor, factors: Sequence[torch.Tensor], loss: Loss,
             lam: float, lr: float, state: AdamState,
             use_adam: bool = True, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, ctx: AxisCtx = LOCAL,
             mttkrp_path: Optional[str] = None, block_rows: int = 8
             ) -> Tuple[List[torch.Tensor], AdamState]:
    """One full-batch generalized-loss update (GD or Adam)."""
    grads = gcp_gradients(st, factors, loss, lam, ctx,
                          mttkrp_path=mttkrp_path, block_rows=block_rows)
    fs = list(factors)
    if not use_adam:
        return [f - lr * g for f, g in zip(fs, grads)], state
    count = state.count + 1
    # bias corrections on the device, from the device count
    k = count.to(fs[0].dtype)
    c1, c2 = 1 - b1 ** k, 1 - b2 ** k
    mus, nus, out = [], [], []
    for f, g, mu, nu in zip(fs, grads, state.mu, state.nu):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mu_hat = mu / c1
        nu_hat = nu / c2
        out.append(f - lr * mu_hat / (torch.sqrt(nu_hat) + eps))
        mus.append(mu)
        nus.append(nu)
    return out, AdamState(mus, nus, count)
