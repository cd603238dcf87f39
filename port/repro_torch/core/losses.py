"""Generalized elementwise losses.

Tensor completion minimizes  Σ_{n∈Ω} ℓ(t_n, m_n) + λ Σ_d ‖A_d‖²_F  where
m_n = Σ_r Π_d A_d[i_d(n), r] is the CP model value at a nonzero. The
first-order solver (``completion.gcp``) needs the elementwise value and
gradient at the observed entries; the generalized Gauss-Newton solver
(``completion.gauss_newton``) also needs the curvature ∂²ℓ/∂m², which
weights the implicit Gram matvec (paper eq. 3) at those entries.

Each loss provides value(t, m), grad(t, m) = ∂ℓ/∂m and hess(t, m) = ∂²ℓ/∂m²,
written by hand as in the reference (``src/repro/core/losses.py``), clamp
regions included: the clamped ``poisson`` has gradient 1 and curvature 0 at
m ≤ ε, and ``huber`` has curvature 0 outside δ. The identity-link
``poisson`` is unbounded below as m falls under ε (its value there is
m − t·log ε), exactly as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# clamp of the model value before exp() where a log-link model is read as a
# rate: the held-out metrics (``data.streaming.heldout_metrics``) and the
# served predictions (``serve.model.apply_link``) share it, so a served
# score equals what the fit's held-out metrics evaluated
LOG_CLIP = 30.0


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    value: Callable  # (t, m) -> elementwise loss
    grad: Callable   # (t, m) -> dloss/dm
    hess: Callable   # (t, m) -> d²loss/dm² (GGN curvature weight)


quadratic = Loss(
    "quadratic",
    value=lambda t, m: torch.square(t - m),
    grad=lambda t, m: 2.0 * (m - t),
    hess=lambda t, m: torch.full_like(m, 2.0),
)

# Poisson log-likelihood with identity link: ℓ = m - t·log(max(m, ε)).
# Below the floor the log term is constant in m, so the derivative of the
# clamped value is 1 and its curvature 0.
_EPS = 1e-6
poisson = Loss(
    "poisson",
    value=lambda t, m: m - t * torch.log(torch.clamp(m, min=_EPS)),
    grad=lambda t, m: torch.where(m > _EPS,
                                  1.0 - t / torch.clamp(m, min=_EPS), 1.0),
    hess=lambda t, m: torch.where(m > _EPS,
                                  t / torch.square(torch.clamp(m, min=_EPS)),
                                  0.0),
)

# Poisson with log link: ℓ = exp(m) - t·m (the model holds the log rate)
poisson_log = Loss(
    "poisson_log",
    value=lambda t, m: torch.exp(m) - t * m,
    grad=lambda t, m: torch.exp(m) - t,
    hess=lambda t, m: torch.exp(m),
)

# Bernoulli logit, t ∈ {0, 1}: ℓ = log(1 + exp(m)) - t·m. logaddexp, not
# softplus: softplus turns linear above its threshold, the reference does not
logistic = Loss(
    "logistic",
    value=lambda t, m: torch.logaddexp(torch.zeros_like(m), m) - t * m,
    grad=lambda t, m: torch.sigmoid(m) - t,
    hess=lambda t, m: torch.sigmoid(m) * torch.sigmoid(-m),
)


def _huber_val(t, m, delta=1.0):
    a = torch.abs(t - m)
    return torch.where(a <= delta, 0.5 * torch.square(a),
                       delta * (a - 0.5 * delta))


def _huber_grad(t, m, delta=1.0):
    return torch.clamp(m - t, -delta, delta)


def _huber_hess(t, m, delta=1.0):
    return torch.where(torch.abs(m - t) < delta, 1.0, 0.0).to(m.dtype)


huber = Loss("huber", value=_huber_val, grad=_huber_grad, hess=_huber_hess)

LOSSES = {l.name: l for l in (quadratic, poisson, poisson_log, logistic, huber)}
