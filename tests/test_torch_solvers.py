"""Parity of the PyTorch port's generalized-loss solvers with the JAX
package's LOCAL functions: the H-sliced and pairwise TTTP, the H-sliced Gram
matvec, GCP, CCD++ (both variants), SGD on the reference's own sample, and
every piece of the generalized Gauss-Newton solver up to ``ggn_sweep``.

Inputs come from a numpy seed (a function-tensor-like sample, shuffled with
COO padding) and feed both packages; the port runs on the CPU, where its
kernel wrappers take their plain versions. The tolerance is the reference's
own, rtol = atol = 1e-4 in float32, except where a test states a wider one
and why.

The GGN problems are order 3 (the reference's GGN tests are order 3 only).
The line search's α is a discrete choice, so the tests compare it, and the
damping that follows from it, exactly. The iterations are compared in
float64, where the two packages agree to 2e-10 and summation order cannot
tip the argmin over the 11 objectives; the pieces in float32. ``poisson``
(identity link, unbounded below once the model drops under ε) runs from
positive factors drawn as ``examples/poisson_completion.py`` draws them,
|N(0, 1)|·0.3 + 0.05. The reference's eager GGN compiles its loops anew on
every call (about 2.5 s a ``ggn_sweep`` on a CPU, whatever the size), which
sets this file's time."""
import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core import tttp as jtttp
from repro.core.completion import als as jals
from repro.core.completion import ccd as jccd
from repro.core.completion import gauss_newton as jggn
from repro.core.completion import gcp as jgcp
from repro.core.completion import sgd as jsgd
from repro.core.sparse_tensor import SparseTensor as JSparseTensor

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core import tttp  # noqa: E402
from repro_torch.core.completion import als  # noqa: E402
from repro_torch.core.completion import ccd  # noqa: E402
from repro_torch.core.completion import gauss_newton as ggn  # noqa: E402
from repro_torch.core.completion import gcp  # noqa: E402
from repro_torch.core.completion import sgd  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.sparse import ccsr  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAM = 1e-5
ORDERS = {3: ((30, 25, 20), 1500, 6), 4: ((14, 12, 10, 8), 1200, 6)}
# GGN problem: shape, nnz, rank
_GGN = ((20, 16, 12), 900, 4)
GGN_LOSSES = ["quadratic", "poisson_log", "poisson"]
# reduced trip counts keep the reference's eager GGN runs short
GGN_ITERS = dict(cg_iters=10, joint_iters=6, precond_iters=4)


def _arrays(seed, shape, nnz, r, positive=False):
    """Shuffled padded COO of a smooth function sample, plus factors."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1) \
        .astype(np.int32)
    grids = [rng.uniform(-1, 1, s) for s in shape]
    arg = sum(g[idx[:, d]] for d, g in enumerate(grids))
    vals = (1 / (1 + np.exp(-3 * arg))).astype(np.float32)
    cap = nnz + 17
    perm = rng.permutation(cap)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((cap - nnz,) + a.shape[1:], a.dtype)])
    valid = np.arange(cap) < nnz
    if positive:
        factors = [np.abs(rng.standard_normal((s, r))) * 0.3 + 0.05
                   for s in shape]
    else:
        factors = [rng.standard_normal((s, r)) / np.sqrt(r) for s in shape]
    factors = [f.astype(np.float32) for f in factors]
    return pad(idx)[perm], pad(vals)[perm], valid[perm], factors


def _pair(seed, shape, nnz, r, positive=False):
    """The same tensor and factors in both packages."""
    idx, vals, valid, factors = _arrays(seed, shape, nnz, r, positive)
    j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(valid),
                      shape, nnz)
    t = interop.sparse_from_numpy(idx, vals, valid, shape, "cpu")
    return (j, [jnp.asarray(f) for f in factors],
            t, interop.factors_from_numpy(factors, "cpu"))


def _ggn_pair(loss, seed=0):
    shape, nnz, r = _GGN
    return _pair(seed, shape, nnz, r, positive=(loss == "poisson"))


def _close(got, want, err="", **tol):
    for d, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"{err} factor {d}",
                                   **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# TTTP variants and the H-sliced Gram matvec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [3, 4])
def test_tttp_sliced_and_pairwise_match_reference(order):
    shape, nnz, r = ORDERS[order]
    j, jf, t, tf = _pair(1, shape, nnz, r)
    for fs_j, fs_t in ((jf, tf), ([None] + jf[1:], [None] + tf[1:])):
        want = jtttp.tttp(j, fs_j).values
        for h in (1, 2, 3):
            got = tttp.tttp_sliced(t, fs_t, h)
            np.testing.assert_allclose(
                got.values.numpy(),
                np.asarray(jtttp.tttp_sliced(j, fs_j, h).values), **TOL)
            np.testing.assert_allclose(got.values.numpy(), np.asarray(want),
                                       **TOL)
        got = tttp.tttp_pairwise(t, fs_t)
        np.testing.assert_allclose(
            got.values.numpy(),
            np.asarray(jtttp.tttp_pairwise(j, fs_j).values), **TOL)
    np.testing.assert_allclose(float(tttp.cp_residual_norm(t, tf)),
                               float(jtttp.cp_residual_norm(j, jf)), **TOL)


def test_tttp_sliced_refuses_indivisible_rank():
    j, jf, t, tf = _pair(2, (10, 9, 8), 100, 5)
    with pytest.raises(ValueError, match="not divisible"):
        jtttp.tttp_sliced(j, jf, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tttp.tttp_sliced(t, tf, 2)


@pytest.mark.parametrize("order,h,r", [(3, 2, 6), (3, 3, 5), (4, 3, 4)])
def test_sliced_gram_matvec_matches_reference(order, h, r, monkeypatch):
    """The H-sliced route at ⌈R/H⌉-column slices: the last one narrower at
    R = 5, and at R = 4, H = 3 only two slices hold columns. Non-uniform
    weights. After each mode's first call nothing is gathered through the
    bucket pattern."""
    shape, nnz, _ = ORDERS[order]
    j, jf, t, tf = _pair(3, shape, nnz, r)
    jw = j.with_values(jnp.abs(j.values) + 0.3)
    tw = t.with_values(torch.abs(t.values) + 0.3)
    calls = []
    gather = ccsr.BucketPattern.gather
    monkeypatch.setattr(ccsr.BucketPattern, "gather",
                        lambda self, st: calls.append(1) or gather(self, st))
    for mode in range(order):
        x = np.random.default_rng(mode).standard_normal(
            (shape[mode], r)).astype(np.float32)
        want = jals.gram_matvec(jw, jf, mode, jnp.asarray(x), LAM, h_slices=h)
        for path in ("fused", "tttp_mttkrp"):
            got = als.gram_matvec(tw, tf, mode, _t(x), LAM, h_slices=h,
                                  matvec_path=path)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"mode {mode}", **TOL)
    assert len(calls) == order


# ---------------------------------------------------------------------------
# GCP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_gcp_matches_reference(name):
    """Objective, gradients, one GD step and two Adam steps (moments and
    count too), per loss, with λ = 1e-3 so the regularizer shows."""
    lam, lr = 1e-3, 1e-2
    j, jf, t, tf = _pair(4, (18, 15, 12), 700, 4,
                         positive=(name == "poisson"))
    jl, tl = jlosses.LOSSES[name], losses.LOSSES[name]
    np.testing.assert_allclose(float(gcp.gcp_loss(t, tf, tl, lam)),
                               float(jgcp.gcp_loss(j, jf, jl, lam)), **TOL)
    _close(gcp.gcp_gradients(t, tf, tl, lam),
           jgcp.gcp_gradients(j, jf, jl, lam), "gradient")
    gd, _ = gcp.gcp_step(t, tf, tl, lam, lr, gcp.gcp_adam_init(tf),
                         use_adam=False)
    jgd, _ = jgcp.gcp_step(j, jf, jl, lam, lr, jgcp.gcp_adam_init(jf),
                           use_adam=False)
    _close(gd, jgd, "GD step")
    fs, state = tf, gcp.gcp_adam_init(tf)
    jfs, jstate = jf, jgcp.gcp_adam_init(jf)
    for step in range(2):
        fs, state = gcp.gcp_step(t, fs, tl, lam, lr, state)
        jfs, jstate = jgcp.gcp_step(j, jfs, jl, lam, lr, jstate)
        _close(fs, jfs, f"Adam step {step}")
        _close(state.mu, jstate.mu, "mu")
        _close(state.nu, jstate.nu, "nu")
    assert state.count.dtype == torch.int32 and state.count.dim() == 0
    assert int(state.count) == int(jstate.count) == 2


# ---------------------------------------------------------------------------
# CCD++
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [3, 4])
def test_ccd_sweeps_match_reference_and_each_other(order):
    shape, nnz, r = ORDERS[order]
    j, jf, t, tf = _pair(5, shape, nnz, r)
    rho = ccd.residual_values(t, tf)
    jrho = jccd.residual_values(j, jf)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), **TOL)
    before = [f.clone() for f in tf]
    got = {}
    for name, port, ref in (("ccd", ccd.ccd_sweep, jccd.ccd_sweep),
                            ("ccd_tttp", ccd.ccd_sweep_tttp,
                             jccd.ccd_sweep_tttp)):
        fs, rho1 = port(t, tf, rho, 0.1)
        jfs, jrho1 = ref(j, jf, jrho, 0.1)
        _close(fs, jfs, name)
        np.testing.assert_allclose(rho1.numpy(), np.asarray(jrho1), **TOL)
        got[name] = (fs, rho1)
    _close(got["ccd"][0], got["ccd_tttp"][0], "ccd vs ccd_tttp")
    # the sweep writes columns into its own copies
    for f, b in zip(tf, before):
        assert torch.equal(f, b)


def test_ccd_tttp_refuses_planner_path():
    j, jf, t, tf = _pair(5, (10, 9, 8), 100, 3)
    with pytest.raises(NotImplementedError, match="planner"):
        ccd.ccd_sweep_tttp(t, tf, ccd.residual_values(t, tf), 0.1,
                           tttp_path="all_at_once")


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [3, 4])
def test_sgd_update_on_reference_sample_matches(order):
    """jax.random cannot be reproduced in torch: the port's update runs on
    the sample the reference's ``sample_entries`` drew."""
    shape, nnz, r = ORDERS[order]
    j, jf, t, tf = _pair(6, shape, nnz, r)
    key, size, lr = jax.random.PRNGKey(order), 400, 1e-3
    js = jsgd.sample_entries(key, j, size)
    sample = interop.sparse_from_numpy(js.indices, js.values, js.valid,
                                       shape, "cpu")
    want = jsgd.sgd_sweep(key, j, jf, LAM, lr, size)
    got = sgd.sgd_update(t, sample, tf, LAM, lr)
    _close(got, want, "sgd")


def test_sample_entries_skips_padding_and_falls_back_when_empty():
    rng = np.random.default_rng(7)
    shape, cap = (12, 10, 8), 300
    idx = np.stack([rng.integers(0, s, cap) for s in shape], 1) \
        .astype(np.int32)
    valid = rng.uniform(size=cap) < 0.3
    # padding slots hold a value no valid entry has
    vals = np.where(valid, rng.uniform(size=cap), 99.0).astype(np.float32)
    st = SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                      torch.from_numpy(valid), shape, int(valid.sum()))
    gen = torch.Generator().manual_seed(0)
    s = sgd.sample_entries(gen, st, 5000)
    assert s.cap == s.nnz == 5000 and bool(s.valid.all())
    assert float(s.values.max()) < 99.0
    valid_rows = {tuple(row) for row in idx[valid]}
    assert {tuple(row) for row in s.indices.numpy()} <= valid_rows
    # every valid slot is reachable: with 5000 draws over ~90 slots
    assert len({tuple(row) for row in s.indices.numpy()}) == len(valid_rows)

    # a tensor with no valid entry: the sample is all invalid, and the
    # sweep moves the factors by the regularizer alone, as the reference's
    empty = SparseTensor(st.indices, torch.zeros(cap), torch.zeros(cap,
                         dtype=torch.bool), shape, 0)
    s = sgd.sample_entries(gen, empty, 64)
    assert s.cap == 64 and not bool(s.valid.any())
    assert bool((s.indices < torch.tensor(shape)).all())
    fs = interop.factors_from_numpy(
        [rng.standard_normal((d, 3)).astype(np.float32) for d in shape],
        "cpu")
    got = sgd.sgd_sweep(gen, empty, fs, 0.1, 0.5, 64)
    jempty = JSparseTensor(jnp.asarray(idx), jnp.zeros(cap),
                           jnp.zeros(cap, bool), shape, 0)
    want = jsgd.sgd_sweep(jax.random.PRNGKey(0), jempty,
                          [jnp.asarray(f.numpy()) for f in fs], 0.1, 0.5, 64)
    _close(got, want, "empty")


# ---------------------------------------------------------------------------
# generalized Gauss-Newton
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GGN_LOSSES)
def test_curvature_and_joint_matvec_match_reference(name):
    j, jf, t, tf = _ggn_pair(name)
    jl, tl = jlosses.LOSSES[name], losses.LOSSES[name]
    jw, jm = jggn.curvature_tensor(j, jf, jl)
    tw, tm = ggn.curvature_tensor(t, tf, tl)
    # the reference's model values are not masked: compare valid slots
    valid = t.valid.numpy()
    np.testing.assert_allclose(tm.numpy()[valid], np.asarray(jm)[valid],
                               **TOL)
    # the curvature of poisson runs to t/m² for small m: held relative
    np.testing.assert_allclose(tw.values.numpy(), np.asarray(jw.values),
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(jw.values).max()))
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal(f.shape).astype(np.float32) for f in tf]
    shift = 2 * LAM + 1e-3
    want = jggn.joint_ggn_matvec(j, jw, jf, [jnp.asarray(x) for x in xs],
                                 shift)
    got = ggn.joint_ggn_matvec(t, tw, tf, [_t(x) for x in xs], shift)
    for d, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=f"mode {d}")


@pytest.mark.parametrize("name", GGN_LOSSES)
def test_ggn_update_mode_matches_reference(name):
    """Both matvec routes against the reference's per-mode update."""
    j, jf, t, tf = _ggn_pair(name, seed=1)
    jl, tl = jlosses.LOSSES[name], losses.LOSSES[name]
    for mode in range(3):
        want = jggn.ggn_update_mode(j, jf, mode, jl, LAM, 1e-3, cg_iters=10)
        for path in ("fused", "tttp_mttkrp"):
            got = ggn.ggn_update_mode(t, tf, mode, tl, LAM, 1e-3,
                                      cg_iters=10, matvec_path=path)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"mode {mode} {path}", **TOL)


def test_ggn_update_mode_is_als_update_for_quadratic():
    """With ω ≡ 2 and damping 0 the per-mode pass solves the ALS system:
    both run to a 1e-8 residual (40 iterations), the ALS update on the Ω
    indicator, GGN's on the weights 2 (rtol = atol = 2e-3: two float32 CG
    solves that start from different points)."""
    j, jf, t, tf = _ggn_pair("quadratic", seed=2)
    omega = t.with_values(torch.ones_like(t.values))
    for path in ("fused", "tttp_mttkrp"):
        got = ggn.ggn_update_mode(t, tf, 0, losses.quadratic, LAM, 0.0,
                                  cg_tol=1e-8, cg_iters=40, matvec_path=path)
        want = als.als_update_mode(t, omega, tf, 0, LAM, cg_tol=1e-8,
                                   cg_iters=40, matvec_path=path)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("name", GGN_LOSSES)
def test_ggn_sweep_and_joint_step_match_reference_per_iteration(
        name, monkeypatch):
    """Two GGN iterations from the same start, in float64 (jax's x64 mode on
    for the reference): after each, the joint step's α and the damping
    exactly (so the line search, accept/reject and damping branches agree),
    and the factors after the joint step and after the iteration at
    rtol = atol = 1e-8; the two packages' float64 sums agree to 2e-10 here.
    Not float32: on these problems the second iteration's CG solves carry
    float32 rounding to 3e-3 (quadratic) and 3e-2 (poisson), and the
    reference's own float32 run lies as far from its float64 run (a one-off
    check when this test was written). The float32 pieces (curvature, joint
    matvec, per-mode update) are held at 1e-4 above."""
    steps = {"port": [], "ref": []}
    for who, mod in (("port", ggn), ("ref", jggn)):
        def recording(*a, _step=mod.joint_ggn_step, _who=who, **kw):
            out = _step(*a, **kw)
            steps[_who].append(out)
            return out
        monkeypatch.setattr(mod, "joint_ggn_step", recording)
    idx, vals, valid, fs = _arrays(0, *_GGN, positive=(name == "poisson"))
    fs = [f.astype(np.float64) for f in fs]
    shape, nnz, _ = _GGN
    with jax.enable_x64(True):
        j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals, jnp.float64),
                          jnp.asarray(valid), shape, nnz)
        t = interop.sparse_from_numpy(idx, vals.astype(np.float64), valid,
                                      shape, "cpu")
        jstate = jggn.ggn_init([jnp.asarray(f) for f in fs])
        state = ggn.ggn_init([torch.from_numpy(f) for f in fs])
        assert state.damping.dtype == torch.float64
        for it in range(2):
            jstate = jggn.ggn_sweep(j, jstate, jlosses.LOSSES[name], LAM,
                                    **GGN_ITERS)
            state = ggn.ggn_sweep(t, state, losses.LOSSES[name], LAM,
                                  **GGN_ITERS)
            (pfs, alpha), (rfs, jalpha) = steps["port"][it], steps["ref"][it]
            assert float(alpha) == float(jalpha) > 0, it
            _close(pfs, rfs, f"joint step {it}", rtol=1e-8, atol=1e-8)
            assert state.damping.dim() == 0
            assert float(state.damping) == float(jstate.damping), it
            _close(state.factors, jstate.factors, f"iteration {it}",
                   rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_port_sources_import_neither_jax_nor_repro():
    """No module under port/repro_torch imports jax or the JAX package, at
    any place in the file (the subprocess test in test_torch_sparse.py
    checks the top-level imports at run time)."""
    root = os.path.join(PORT, "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 25
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
