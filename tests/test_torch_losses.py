"""Parity of the PyTorch port's losses with the JAX package's, and of their
hand-written derivatives with torch.autograd.

Inputs come from a numpy seed and include the clamp regions: ``poisson``
below and above its floor ε, ``huber`` inside and outside δ, ``logistic``
far out on both tails. Against the JAX package the tolerance is the
reference's own, rtol = atol = 1e-4 in float32 (the curvature of
``poisson`` reaches 1e11 near ε, which rtol covers). Against autograd the
port's formulas run in float64, at rtol = atol = 1e-8."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.core import losses  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
EPS = jlosses._EPS
# clamp-region probes, strictly off the boundaries (poisson's ε, huber's
# δ = 1 around t), and logistic's tails
M_PROBES = [-40.0, -2.0, -1e-3, 1e-8, 1e-7, EPS * 0.5, EPS * 3.0, 1e-4, 0.3,
            2.5, 4.0, 25.0, 40.0]


def _sample(name, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = np.abs(rng.standard_normal(64)) + 0.1
    if name == "logistic":
        t = (t > 0.5).astype(np.float64)
    if name == "poisson":
        t = np.round(t * 3)
    m = 2.0 * rng.standard_normal(64)
    t_probe = np.full(len(M_PROBES), 1.0 if name == "logistic" else t[0])
    return (np.concatenate([t, t_probe]).astype(dtype),
            np.concatenate([m, M_PROBES]).astype(dtype))


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_loss_matches_reference(name):
    assert sorted(losses.LOSSES) == sorted(jlosses.LOSSES)
    ref, port = jlosses.LOSSES[name], losses.LOSSES[name]
    assert port.name == ref.name == name
    for seed in (0, 7, 123):
        t, m = _sample(name, seed)
        for part in ("value", "grad", "hess"):
            want = np.asarray(getattr(ref, part)(jnp.asarray(t),
                                                 jnp.asarray(m)))
            got = getattr(port, part)(torch.from_numpy(t),
                                      torch.from_numpy(m))
            assert got.dtype == torch.float32, (part, got.dtype)
            np.testing.assert_allclose(got.numpy(), want,
                                       err_msg=f"{name}.{part}", **TOL)


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_derivatives_match_autograd(name):
    """grad = ∂value/∂m and hess = ∂grad/∂m, by torch.autograd of the
    port's own value, clamp regions included."""
    loss = losses.LOSSES[name]
    t, m = (torch.from_numpy(a) for a in _sample(name, 3, np.float64))
    m = m.requires_grad_(True)
    (g,) = torch.autograd.grad(loss.value(t, m).sum(), m, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), m)
    np.testing.assert_allclose(loss.grad(t, m).detach().numpy(),
                               g.detach().numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(loss.hess(t, m).detach().numpy(), h.numpy(),
                               rtol=1e-8, atol=1e-8)


def test_clamp_regions():
    """poisson: grad 1 and hess 0 at m ≤ ε, and unbounded below there
    (value m − t·log ε), as in the reference; huber: hess 0 outside δ."""
    t = torch.tensor([3.0, 1.0, 7.0])
    m = torch.tensor([-1.0, 0.0, EPS * 0.25])
    assert torch.equal(losses.poisson.grad(t, m), torch.ones(3))
    assert torch.equal(losses.poisson.hess(t, m), torch.zeros(3))
    deep = losses.poisson.value(torch.tensor([1.0]), torch.tensor([-1e6]))
    assert float(deep) < -1e5
    t = torch.zeros(4)
    m = torch.tensor([-3.0, -0.5, 0.5, 3.0])
    np.testing.assert_array_equal(losses.huber.hess(t, m).numpy(),
                                  [0.0, 1.0, 1.0, 0.0])
    np.testing.assert_array_equal(losses.huber.grad(t, m).numpy(),
                                  [-1.0, -0.5, 0.5, 1.0])


def test_curvatures_nonnegative():
    for name, loss in losses.LOSSES.items():
        t, m = (torch.from_numpy(a) for a in _sample(name, 11))
        assert bool((loss.hess(t, m) >= 0).all()), name
