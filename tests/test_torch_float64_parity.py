"""Float64 operands: the port's kernels against the JAX package's
``repro.kernels.ops`` on the same numpy inputs in float64 (jax's x64 mode),
both the reference's plain route and its Pallas kernels in interpret mode
under a float64 accumulator (``KernelTile(accum_dtype="float64")``, the
feature the port's float64 instantiations carry to the card). On the CPU the
port runs its plain versions; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 2 and 4c hold the float64 CUDA instantiations
against those at rtol 1e-10 + 1e-12 x max |plain|. Tolerance here: the
same sums in another order, rtol = atol = 1e-12 (values of order 1,
a few hundred terms a row)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.kernels import ops as jkops
from repro.kernels.tile import KernelTile as JKernelTile
from repro.sparse.ccsr import bucketize as jbucketize

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

F64_TOL = dict(rtol=1e-12, atol=1e-12)
ROUTES = ["plain", "pallas"]


def _route(route):
    """The reference's keyword arguments for ``route``: its Pallas kernels
    accumulate in the tile's type, so they get a float64 tile."""
    if route == "plain":
        return dict(use_pallas=False)
    return dict(use_pallas=True, tile=JKernelTile(accum_dtype="float64"))


def _problem(seed, shape, nnz, r):
    """The same float64 padded COO and factors in both packages (jax
    arrays built under x64)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape],
                   1).astype(np.int32)
    vals = rng.standard_normal(nnz)
    fnp = [rng.standard_normal((s, r)) for s in shape]
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), shape,
                               cap=nnz + 37)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values),
                                  np.asarray(j.valid), shape, "cpu")
    assert j.values.dtype == jnp.float64 and t.values.dtype == torch.float64
    return j, [jnp.asarray(f) for f in fnp], t, [torch.from_numpy(f)
                                                  for f in fnp]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape,nnz,r", [((64, 32, 16), 500, 10),
                                         ((20, 12, 10, 8), 300, 3)])
def test_tttp_float64_matches_reference(route, shape, nnz, r):
    with jax.enable_x64(True):
        j, jf, t, tf = _problem(0, shape, nnz, r)
        want = np.asarray(jkops.tttp_values(j, jf, **_route(route)))
    got = kops.tttp_values(t, tf)
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", [0, 2])
def test_mttkrp_float64_matches_reference(route, mode):
    shape = (64, 32, 16)
    with jax.enable_x64(True):
        j, jf, t, tf = _problem(1, shape, 500, 10)
        jf[mode], tf[mode] = None, None
        want = np.asarray(jkops.mttkrp_bucketed(
            jbucketize(j, mode, block_rows=8), jf, num_rows=shape[mode],
            **_route(route)))
    got = kops.mttkrp_bucketed(t.row_buckets(mode, 8), tf)
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@pytest.mark.parametrize("route", ROUTES)
def test_cg_matvec_float64_matches_reference(route):
    shape = (64, 32, 16)
    xnp = np.random.default_rng(3).standard_normal((64, 10))
    with jax.enable_x64(True):
        j, jf, t, tf = _problem(2, shape, 500, 10)
        jo = j.with_values(jnp.ones_like(j.values))
        want = np.asarray(jkops.cg_matvec_bucketed(
            jbucketize(jo, 0, block_rows=8), [None] + jf[1:],
            jnp.asarray(xnp), num_rows=64, **_route(route)))
    to = t.with_values(torch.ones_like(t.values))
    got = kops.cg_matvec_bucketed(to.row_buckets(0, 8), [None] + tf[1:],
                                  torch.from_numpy(xnp))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)
