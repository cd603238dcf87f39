"""A float64 accumulator over float32 and bf16 operands: the port's plain
versions under ``KernelTile(accum_dtype="float64")`` against the JAX
package's ``repro.kernels.ops`` on the same numpy inputs, under jax's x64
mode. The reference's Pallas kernels (interpret mode) take the same float64
tile; its plain route sums in its operands' type, so it gets the operands
cast to float64 (the function a float64 accumulator computes). Covered:
TTTP over the COO and over a bucket view, the bucketed MTTKRP at modes 0
and 2, and the fused Gram matvec.

Tolerance: the outputs are float32 and may differ by one rounding: at most
one unit in the last place of float32 at |reference| (plus 1e-30 for
exact zeros). The structured cases draw their values from a grid of
multiples of 1/32 below 2 in magnitude (at most 7 significant bits), so
every product of an order-3 tensor's Hadamard chain is exact in float32
and the two routes sum the same terms; the generic case (normal values)
is held against the Pallas route, whose float32 products are the port's.
The cancellation cases sum terms of 2^30 that cancel around small ones: a
float32 sum misses them by far more than one rounding (the test checks
that it does), a float64 one does not. bf16 operands are held at 6e-2,
the reference's bf16 bound."""
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
from repro_torch.kernels.tile import KernelTile  # noqa: E402

ROUTES = ["plain", "pallas"]
WIDE = KernelTile(accum_dtype="float64")
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
BIG = 2.0 ** 30
# one shape, rank, padded capacity and bucket capacity for every case, so
# the reference's jitted wrappers compile once per route and kernel
SHAPE, R, CAP, BUCKET_CAP = (16, 8, 6), 10, 700, 512


def _route(route):
    if route == "plain":
        return dict(use_pallas=False)
    return dict(use_pallas=True, tile=JKernelTile(accum_dtype="float64"))


def _ref_in(route, a):
    """The reference's operand for ``route``: float64 for its plain route
    (which sums in its operands' type), the array itself for Pallas."""
    if a is None or route == "pallas":
        return a
    return a.astype(jnp.float64)


def _one_rounding(got, want):
    """|got - want| within one float32 unit in the last place of |want|."""
    want32 = np.asarray(want, np.float32)
    got = np.asarray(got)
    assert got.dtype == np.float32 and want32.shape == got.shape
    ulp = np.spacing(np.abs(want32)).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want32.astype(np.float64))
    assert (err <= ulp + 1e-30).all(), (err.max(), ulp[err.argmax()])


def _grid(rng, size):
    """Multiples of 1/32 in (-2, 2): at most 7 significant bits."""
    return (rng.integers(-63, 64, size) / 32.0).astype(np.float32)


def _pair(idx, vals, shape=SHAPE):
    """The same padded COO in both packages (float32 values)."""
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), shape,
                               cap=CAP)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values),
                                  np.asarray(j.valid), shape, "cpu")
    return j, t


def _problem(seed, nnz=400, grid=True, shape=SHAPE, r=R):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape],
                   1).astype(np.int32)
    if grid:
        vals = _grid(rng, nnz)
        fnp = [_grid(rng, (s, r)) for s in shape]
    else:
        vals = rng.standard_normal(nnz).astype(np.float32)
        fnp = [rng.standard_normal((s, r)).astype(np.float32) for s in shape]
    j, t = _pair(idx, vals, shape)
    return j, fnp, t


def _cancel_tttp(r=R):
    """Every nonzero's R-sum is 2^30 + (R - 2) - 2^30, exact in float32
    terms: columns 0 and R-1 of the mode-0 rows are 2^10 and -2^10, of the
    other modes' rows 2^10, the rest 1."""
    shape = SHAPE
    rng = np.random.default_rng(7)
    nnz = 40
    idx = np.stack([rng.integers(0, s, nnz) for s in shape],
                   1).astype(np.int32)
    vals = np.ones(nnz, np.float32)
    fnp = []
    for d, s in enumerate(shape):
        f = np.ones((s, r), np.float32)
        f[:, 0] = 2.0 ** 10
        f[:, -1] = -(2.0 ** 10) if d == 0 else 2.0 ** 10
        fnp.append(f)
    j, t = _pair(idx, vals, shape)
    return j, fnp, t, float(r - 2)


def _cancel_rows(mode, ones=40):
    """Each row of ``mode`` holds, in COO order, a value 2^30, ``ones``
    values 1 and a value -2^30, all factors 1: its MTTKRP row is ``ones``
    in every column."""
    shape = SHAPE
    rng = np.random.default_rng(11 + mode)
    rows = np.arange(shape[mode])
    idx, vals = [], []
    for i in rows:
        for v in [BIG] + [1.0] * ones + [-BIG]:
            c = [int(rng.integers(0, s)) for s in shape]
            c[mode] = int(i)
            idx.append(c)
            vals.append(v)
    j, t = _pair(np.asarray(idx, np.int32), np.asarray(vals, np.float32),
                 shape)
    return j, [np.ones((s, R), np.float32) for s in shape], t, float(ones)


# ---------------------------------------------------------------------------
# TTTP over the COO and over a bucket view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["grid", "cancellation"])
def test_tttp_float64_accumulator_matches_reference(route, case):
    if case == "grid":
        j, fnp, t = _problem(0)
        exact = None
    else:
        j, fnp, t, exact = _cancel_tttp()
    with jax.enable_x64(True):
        jj = j.astype(jnp.float64) if route == "plain" else j
        want = np.asarray(jkops.tttp_values(
            jj, [_ref_in(route, jnp.asarray(f)) for f in fnp],
            **_route(route)), np.float32)
    tf = [torch.from_numpy(f) for f in fnp]
    got = kops.tttp_values(t, tf, WIDE)
    _one_rounding(got.numpy(), want)
    if exact is not None:
        valid = t.valid.numpy()
        assert (got.numpy()[valid] == exact).all()
        # a float32 sum misses them by far more than one rounding
        narrow = kops.tttp_values(t, tf).numpy()[valid]
        assert np.abs(narrow - exact).max() >= 1.0


@pytest.mark.parametrize("route", ROUTES)
def test_tttp_bucket_view_float64_accumulator_matches_reference(route):
    """TTTP over Ω's bucket view (the ``tttp_mttkrp`` matvec's half): the
    reference's TTTP of the same entries, slot by slot, 0 on padding."""
    j, fnp, t = _problem(1)
    bo = t.row_buckets(0, 8)
    got = kops.tttp_bucket_values(bo, [torch.from_numpy(f) for f in fnp],
                                  WIDE).numpy().reshape(-1)
    valid = bo.valid.numpy().reshape(-1)
    nd = bo.indices.shape[-1]
    view_idx = bo.indices.numpy().reshape(-1, nd)[valid]
    view_vals = bo.values.numpy().reshape(-1)[valid]
    with jax.enable_x64(True):
        jv = JSparseTensor.from_coo(jnp.asarray(view_idx),
                                    jnp.asarray(view_vals), t.shape, cap=CAP)
        if route == "plain":
            jv = jv.astype(jnp.float64)
        want = np.asarray(jkops.tttp_values(
            jv, [_ref_in(route, jnp.asarray(f)) for f in fnp],
            **_route(route)), np.float32)
    assert (got[~valid] == 0).all()
    _one_rounding(got[valid], want[:int(valid.sum())])


def test_tttp_generic_values_match_the_pallas_route():
    """Normal values: the port's float32 products are the Pallas kernel's,
    so the two float64 sums round to float32 within one unit."""
    j, fnp, t = _problem(2, grid=False)
    with jax.enable_x64(True):
        want = np.asarray(jkops.tttp_values(
            j, [jnp.asarray(f) for f in fnp], **_route("pallas")))
    _one_rounding(kops.tttp_values(t, [torch.from_numpy(f) for f in fnp],
                                   WIDE).numpy(), want)


# ---------------------------------------------------------------------------
# MTTKRP at modes 0 and 2, and the fused Gram matvec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("case", ["grid", "cancellation"])
def test_mttkrp_float64_accumulator_matches_reference(route, mode, case):
    if case == "grid":
        j, fnp, t = _problem(3 + mode)
        exact = None
    else:
        j, fnp, t, exact = _cancel_rows(mode)
    shape = t.shape
    fnp = [None if d == mode else f for d, f in enumerate(fnp)]
    with jax.enable_x64(True):
        jj = j.astype(jnp.float64) if route == "plain" else j
        want = np.asarray(jkops.mttkrp_bucketed(
            jbucketize(jj, mode, block_rows=8, capacity=BUCKET_CAP),
            [None if f is None else _ref_in(route, jnp.asarray(f))
             for f in fnp], num_rows=shape[mode], **_route(route)),
            np.float32)
    tf = [None if f is None else torch.from_numpy(f) for f in fnp]
    bk = t.row_buckets(mode, 8)
    got = kops.mttkrp_bucketed(bk, tf, tile=WIDE)
    _one_rounding(got.numpy(), want)
    if exact is not None:
        assert (got.numpy() == exact).all()
        narrow = kops.mttkrp_bucketed(bk, tf).numpy()
        assert np.abs(narrow - exact).max() >= 1.0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["grid", "cancellation"])
def test_cg_matvec_float64_accumulator_matches_reference(route, case):
    shape = SHAPE
    rng = np.random.default_rng(5)
    xnp = _grid(rng, (shape[0], R))
    j, fnp, t = _problem(6)
    if case == "cancellation":
        # each x row's dot with KR is 2^30 + (R - 2) - 2^30
        fnp = [np.ones_like(f) for f in fnp]
        fnp[1][:, 0] = fnp[1][:, -1] = 2.0 ** 15
        fnp[2][:, 0] = fnp[2][:, -1] = 2.0 ** 15
        xnp = np.ones_like(xnp)
        xnp[:, -1] = -1.0
    omega = np.ones(len(np.asarray(j.values)), np.float32)
    with jax.enable_x64(True):
        jo = j.with_values(jnp.asarray(omega))
        if route == "plain":
            jo = jo.astype(jnp.float64)
        want = np.asarray(jkops.cg_matvec_bucketed(
            jbucketize(jo, 0, block_rows=8, capacity=BUCKET_CAP),
            [None] + [_ref_in(route, jnp.asarray(f)) for f in fnp[1:]],
            _ref_in(route, jnp.asarray(xnp)), num_rows=shape[0],
            **_route(route)), np.float32)
    to = t.with_values(torch.ones_like(t.values))
    bo = to.row_buckets(0, 8)
    tf = [None] + [torch.from_numpy(f) for f in fnp[1:]]
    got = kops.cg_matvec_bucketed(bo, tf, torch.from_numpy(xnp), tile=WIDE)
    _one_rounding(got.numpy(), want)
    if case == "cancellation":
        narrow = kops.cg_matvec_bucketed(bo, tf, torch.from_numpy(xnp))
        assert np.abs(narrow.numpy() - want).max() >= 1.0


# ---------------------------------------------------------------------------
# bf16 operands
# ---------------------------------------------------------------------------

def test_bf16_operands_in_a_float64_accumulator_hold_at_the_bf16_bound():
    """bf16 operands under a float64 tile: the port (Hadamard chain in
    float32, as the CUDA kernels take it, sums in float64, output bf16)
    against the reference's Pallas kernels (chain in bf16, float64 tile)
    at 6e-2; MTTKRP at mode 2, the fused matvec and TTTP."""
    j, fnp, t = _problem(8, grid=False)
    rng = np.random.default_rng(9)
    xnp = rng.standard_normal((SHAPE[0], R)).astype(np.float32)
    bf = jnp.bfloat16
    tb = t.astype(torch.bfloat16)
    tf = [torch.from_numpy(f).bfloat16() for f in fnp]
    xb = torch.from_numpy(xnp).bfloat16()
    with jax.enable_x64(True):
        jb = j.astype(bf)
        jf = [jnp.asarray(f).astype(bf) for f in fnp]
        kw = _route("pallas")
        want_t = jkops.tttp_values(jb, jf, **kw)
        want_m = jkops.mttkrp_bucketed(
            jbucketize(jb, 2, block_rows=8, capacity=BUCKET_CAP),
            jf[:2] + [None], num_rows=SHAPE[2], **kw)
        jo = jb.with_values(jnp.ones_like(jb.values))
        want_c = jkops.cg_matvec_bucketed(
            jbucketize(jo, 0, block_rows=8, capacity=BUCKET_CAP),
            [None] + jf[1:], jnp.asarray(xnp).astype(bf),
            num_rows=SHAPE[0], **kw)
        want = [np.asarray(w.astype(jnp.float32))
                for w in (want_t, want_m, want_c)]
    to = tb.with_values(torch.ones_like(tb.values))
    got = [kops.tttp_values(tb, tf, WIDE),
           kops.mttkrp_bucketed(tb.row_buckets(2, 8), tf[:2] + [None],
                                tile=WIDE),
           kops.cg_matvec_bucketed(to.row_buckets(0, 8), [None] + tf[1:], xb,
                                   tile=WIDE)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, **BF16_TOL)
