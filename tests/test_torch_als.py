"""Parity of the PyTorch port's implicit-CG ALS with the JAX package's LOCAL
runs (never a mesh run: the reference's mesh path is no oracle on this jax).

Inputs come from a numpy seed (a function-tensor-like sample, shuffled with
COO padding) and feed both packages. The tolerance is the reference's own,
rtol = atol = 1e-4: CG carries the two packages' different summation orders
through its iterations, and on these problems the factors still agree to
better than 3e-5. Both of the port's matvec routes (the fused CG-matvec
kernel's plain version and TTTP + bucketed MTTKRP) are held to it."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core.completion import als as jals
from repro.core.completion import ccd as jccd
from repro.core.completion import gauss_newton as jggn
from repro.core.completion import gcp as jgcp
from repro.core.completion import sgd as jsgd
from repro.core.sparse_tensor import SparseTensor as JSparseTensor

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop, obs
from repro_torch.core.completion import als
from repro_torch.core.completion import sgd
from repro_torch.launch import complete
from repro_torch.sparse import ccsr

TOL = dict(rtol=1e-4, atol=1e-4)
LAM, CG_TOL, CG_ITERS = 1e-5, 1e-4, 12
PATHS = ["fused", "tttp_mttkrp"]
ORDERS = {3: ((30, 25, 20), 1500, 6), 4: ((14, 12, 10, 8), 1200, 5)}


def _arrays(seed, shape, nnz, r):
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
    factors = [(rng.standard_normal((s, r)) / np.sqrt(r)).astype(np.float32)
               for s in shape]
    return pad(idx)[perm], pad(vals)[perm], valid[perm], factors


def _problem(order, seed=0):
    shape, nnz, r = ORDERS[order]
    idx, vals, valid, factors = _arrays(seed, shape, nnz, r)
    j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(valid),
                      shape, nnz)
    t = interop.sparse_from_numpy(idx, vals, valid, shape, "cpu")
    return (j, j.with_values(jnp.ones_like(j.values)),
            [jnp.asarray(f) for f in factors],
            t, t.with_values(torch.ones_like(t.values)),
            interop.factors_from_numpy(factors, "cpu"))


def _close(got, want, **tol):
    for d, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"factor {d}", **(tol or TOL))


@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("path", PATHS)
def test_gram_matvec_matches_reference(order, path):
    j, jo, jf, t, to, tf = _problem(order, seed=1)
    for mode in range(len(jf)):
        x = np.random.default_rng(mode).standard_normal(tf[mode].shape) \
            .astype(np.float32)
        want = jals.gram_matvec(jo, jf, mode, jnp.asarray(x), LAM)
        got = als.gram_matvec(to, tf, mode, torch.from_numpy(x), LAM,
                              matvec_path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("path", PATHS)
def test_als_update_mode_matches_reference(order, path):
    j, jo, jf, t, to, tf = _problem(order)
    mode = order - 1
    want = jals.als_update_mode(j, jo, jf, mode, LAM, cg_tol=CG_TOL,
                                cg_iters=CG_ITERS)
    got = als.als_update_mode(t, to, tf, mode, LAM, cg_tol=CG_TOL,
                              cg_iters=CG_ITERS, matvec_path=path)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("path", PATHS)
def test_als_sweep_matches_reference(order, path):
    j, jo, jf, t, to, tf = _problem(order)
    sweep = jax.jit(lambda s, o, fs: tuple(jals.als_sweep(
        s, o, list(fs), LAM, cg_tol=CG_TOL, cg_iters=CG_ITERS)))
    want = sweep(j, jo, tuple(jf))
    got = als.als_sweep(t, to, tf, LAM, cg_tol=CG_TOL, cg_iters=CG_ITERS,
                        matvec_path=path)
    _close(got, want)


@pytest.mark.parametrize("path", PATHS)
def test_als_sweep_at_rank_160_matches_reference(path):
    """R = 160 is wider than one launch of the bucketed kernels: the fused
    route's matvec runs as TTTP then MTTKRP, the MTTKRP in column tiles on
    the card. One sweep matches the reference's at rtol 1e-4 and an atol of
    1e-4 of each factor's largest entry: with about 8 nonzeros per row each
    160 × 160 system is held up by λ = 1e-5 alone, and CG carries float32
    summation order far enough that two float32 implementations (the
    reference's own default and h_slices=2 routes among them) differ by
    more than a flat 1e-4 on factor 0, whose entries reach about 10."""
    idx, vals, valid, factors = _arrays(5, (16, 12, 8), 120, 160)
    j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(valid),
                      (16, 12, 8), 120)
    t = interop.sparse_from_numpy(idx, vals, valid, (16, 12, 8), "cpu")
    want = jals.als_sweep(j, j.with_values(jnp.ones_like(j.values)),
                          [jnp.asarray(f) for f in factors], LAM,
                          cg_tol=CG_TOL, cg_iters=CG_ITERS)
    got = als.als_sweep(t, t.with_values(torch.ones_like(t.values)),
                        interop.factors_from_numpy(factors, "cpu"), LAM,
                        cg_tol=CG_TOL, cg_iters=CG_ITERS, matvec_path=path)
    for d, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"factor {d}")


def test_tttp_mttkrp_route_gathers_no_bucket_values(monkeypatch):
    """The TTTP half runs over Ω's cached bucket view and its z feeds the
    MTTKRP as that view's values: after the first call (which gathers Ω's
    view) no call gathers bucket values through the pattern."""
    j, jo, jf, t, to, tf = _problem(3, seed=5)
    calls = []
    gather = ccsr.BucketPattern.gather
    monkeypatch.setattr(ccsr.BucketPattern, "gather",
                        lambda self, st: calls.append(1) or gather(self, st))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        tf[0].shape).astype(np.float32))
    first = als.gram_matvec(to, tf, 0, x, LAM, matvec_path="tttp_mttkrp")
    n = len(calls)
    second = als.gram_matvec(to, tf, 0, x, LAM, matvec_path="tttp_mttkrp")
    assert len(calls) == n <= 1
    assert torch.equal(first, second)
    np.testing.assert_allclose(
        second.numpy(), np.asarray(jals.gram_matvec(jo, jf, 0, jnp.asarray(x),
                                                    LAM)), **TOL)


def test_explicit_baseline_matches_reference_and_implicit_cg():
    """The explicit Gram-forming baseline is a third oracle: it matches the
    reference's, and implicit CG run to convergence matches it."""
    j, jo, jf, t, to, tf = _problem(3, seed=2)
    want = jals.als_sweep_explicit(j, jf, LAM)
    got = als.als_sweep_explicit(t, tf, LAM)
    _close(got, want)
    for mode in range(3):
        direct = als.als_update_mode_explicit(t, tf, mode, LAM)
        cg = als.als_update_mode(t, to, tf, mode, LAM, cg_tol=1e-7,
                                 cg_iters=30)
        # CG to a 1e-7 residual in float32 vs a direct solve
        np.testing.assert_allclose(cg.numpy(), direct.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_batched_cg_fixed_trip_matches_early_exit():
    """The port stops, as the reference's while-loop does, at the first
    iteration in which no row is active (converged rows frozen before
    then). Same x, and the port's device counter gives the reference's
    trip count."""
    rng = np.random.default_rng(3)
    n, r = 40, 6
    a = rng.standard_normal((n, r, r)).astype(np.float32)
    spd = np.einsum("nij,nkj->nik", a, a) + 0.5 * np.eye(r, dtype=np.float32)
    b = rng.standard_normal((n, r)).astype(np.float32)
    x0 = np.zeros_like(b)
    jmv = lambda x: jnp.einsum("nij,nj->ni", jnp.asarray(spd), x)  # noqa
    tmv = lambda x: torch.einsum("nij,nj->ni", torch.from_numpy(spd), x)  # noqa
    jx, jiters = jals.batched_cg(jmv, jnp.asarray(b), jnp.asarray(x0),
                                 tol=1e-5, max_iters=40)
    tx, titers = als.batched_cg(tmv, torch.from_numpy(b),
                                torch.from_numpy(x0), tol=1e-5, max_iters=40)
    assert int(titers) == int(jiters) < 40
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def _staggered_spd(seed=5, n=30, r=6):
    """SPD systems whose rows converge at different CG iterations: a
    multiple of the identity (one step), two distinct eigenvalues (two
    steps), and general SPD blocks (up to r steps)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, r, r))
    spd = np.einsum("nij,nkj->nik", a, a) + 0.5 * np.eye(r)
    third = n // 3
    spd[:third] = 3.0 * np.eye(r)
    q, _ = np.linalg.qr(rng.standard_normal((r, r)))
    two = np.diag([1.0] * (r // 2) + [4.0] * (r - r // 2))
    spd[third:2 * third] = q @ two @ q.T
    spd = torch.from_numpy(spd.astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n, r)).astype(np.float32))
    calls = []

    def mv(x):
        calls.append(1)
        return torch.einsum("nij,nj->ni", spd, x)
    return mv, b, calls


def _cg_counters(fn):
    """``fn()``'s result and what it added to the ``cg/`` counters."""
    obs.get_registry().reset()
    obs.enable()
    try:
        got = fn()
        counters = obs.get_registry().summary()["counters"]
    finally:
        obs.disable()
        obs.get_registry().reset()
    return got, {k: counters.get(k, 0.0) for k in
                 ("cg/iterations", "cg/active_iterations", "cg/early_exits")}


def test_batched_cg_early_exit_equals_fixed_trip_bit_for_bit():
    """The early exit gives the fixed trip's x (run through ``out``, as
    fold-in's graphs run it) bit for bit and the same ``iters``, and runs
    the matvec 1 + ``iters`` times against the fixed trip's
    1 + ``max_iters``; the rows converge at different iterations."""
    mv, b, calls = _staggered_spd()
    x0, budget = torch.zeros_like(b), 30
    (x, iters), counters = _cg_counters(
        lambda: als.batched_cg(mv, b, x0, tol=1e-5, max_iters=budget))
    early_calls = len(calls)
    calls.clear()
    out = (torch.empty_like(b), torch.zeros((), dtype=torch.int32))
    fx, fiters = als.batched_cg(mv, b, x0, tol=1e-5, max_iters=budget,
                                out=out)
    assert fx is out[0] and fiters is out[1]
    assert 2 < int(iters) == int(fiters) < budget
    assert torch.equal(x, fx)
    assert early_calls == 1 + int(iters) and len(calls) == 1 + budget
    assert counters == {"cg/iterations": int(iters),
                        "cg/active_iterations": int(iters),
                        "cg/early_exits": 1}
    # a few iterations in, some rows are done and others are not
    part, _ = als.batched_cg(mv, b, x0, tol=1e-5, max_iters=2)
    res = torch.linalg.vector_norm(b - mv(part), dim=1) \
        / torch.linalg.vector_norm(b, dim=1)
    assert bool((res <= 1e-5).any()) and bool((res > 1e-5).any())


@pytest.mark.parametrize("case", ["no_budget", "converged_start",
                                  "short_budget"])
def test_batched_cg_early_exit_edge_cases(case):
    """``max_iters`` 0 runs no iteration; a start that has already
    converged stops before the first (an early exit, 0 iterations); a
    budget too short to converge runs all of it and records no early
    exit. Each equals the fixed trip through ``out`` bit for bit, and
    runs the matvec 1 + ``iters`` times."""
    mv, b, calls = _staggered_spd()
    budget, x0 = {"no_budget": (0, torch.zeros_like(b)),
                  "converged_start": (10, b.clone()),
                  "short_budget": (2, torch.zeros_like(b))}[case]
    if case == "converged_start":
        b = mv(x0)            # r = b − A x0 is exactly 0
        calls.clear()
    (x, iters), counters = _cg_counters(
        lambda: als.batched_cg(mv, b, x0, tol=1e-5, max_iters=budget))
    want_iters = {"no_budget": 0, "converged_start": 0,
                  "short_budget": budget}[case]
    assert int(iters) == want_iters and len(calls) == 1 + want_iters
    assert counters == {"cg/iterations": want_iters,
                        "cg/active_iterations": want_iters,
                        "cg/early_exits": int(case == "converged_start")}
    out = (torch.empty_like(b), torch.zeros((), dtype=torch.int32))
    fx, fiters = als.batched_cg(mv, b, x0, tol=1e-5, max_iters=budget,
                                out=out)
    assert torch.equal(x, fx) and int(fiters) == want_iters


def test_gram_matvec_planner_options_match_reference():
    """The planner's options, against the reference's: ``mttkrp_path``
    beside the H-sliced route, and the planner's ``matvec_path``
    candidates; an unknown ``matvec_path`` raises."""
    j, jo, jf, t, to, tf = _problem(3)
    want = jals.gram_matvec(jo, jf, 0, jf[0], LAM, h_slices=2,
                            mttkrp_path="bucketed")
    got = als.gram_matvec(to, tf, 0, tf[0], LAM, h_slices=2,
                          mttkrp_path="bucketed")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for path in ("dense", "sliced", "auto"):
        want = jals.gram_matvec(jo, jf, 0, jf[0], LAM, matvec_path=path)
        got = als.gram_matvec(to, tf, 0, tf[0], LAM, matvec_path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=path)
    with pytest.raises(ValueError, match="matvec_path"):
        als.gram_matvec(to, tf, 0, tf[0], LAM, matvec_path="pairwise")


@pytest.mark.parametrize("path", PATHS)
def test_cli_from_npz_matches_reference_sweep(tmp_path, capsys, path):
    """``--init-npz`` starts the CLI from the reference's arrays; one sweep
    matches the reference's LOCAL sweep and ``--dump-factors`` writes it."""
    j, jo, jf, t, to, tf = _problem(3, seed=4)
    src, out = tmp_path / "init.npz", tmp_path / "out.npz"
    np.savez(src, indices=np.asarray(j.indices), values=np.asarray(j.values),
             valid=np.asarray(j.valid), shape=np.asarray(j.shape),
             **{f"factor_{d}": np.asarray(f) for d, f in enumerate(jf)})
    run = complete.main(["--device", "cpu", "--init-npz", str(src),
                         "--sweeps", "2", "--cg-iters", str(CG_ITERS),
                         "--lam", str(LAM), "--matvec-path", path,
                         "--dump-factors", str(out)])
    text = capsys.readouterr().out
    assert "sweep   0" in text and "sweep   1" in text and "rmse=" in text
    want = jals.als_sweep(j, jo, jf, LAM, cg_tol=CG_TOL, cg_iters=CG_ITERS)
    _close(run.sweep_factors[0], want)
    e = [run.rmse0] + [h[2] for h in run.history]
    assert all(np.isfinite(e)) and e[2] < e[1] < e[0]
    with np.load(out) as z:
        for d, f in enumerate(run.factors):
            np.testing.assert_array_equal(z[f"factor_{d}"], f.numpy())


# tests/test_complete_cli.py's CG settings (30 iterations to a 1e-7
# residual), at which the ranks' summation order stays inside 1e-4
MESH_ARGS = ["--device", "cpu", "--force-host-devices", "8", "--dims",
             "40,30,20", "--nnz", "3000", "--rank", "4", "--sweeps", "2",
             "--cg-iters", "30", "--cg-tol", "1e-7", "--seed", "1"]


def _mesh_cli(tmp_path, argv):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(PORT))
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.complete", *argv], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-3000:] + "\n---\n" + \
        out.stderr[-6000:]
    return out.stdout


@pytest.mark.parametrize("argv", [["--mesh", "2,1"],
                                  ["--mesh", "4,2", "--ckpt-dir", "ck"],
                                  ["--mesh", "2,1", "--plan-cache",
                                   "plans.json"]])
def test_cli_mesh_runs(tmp_path, argv):
    """--mesh (refused before distribution was ported) runs on the CPU's
    gloo ranks, alone and with the flags that run beside it: the data-axis
    run equals the LOCAL run from the same seed (rank 0's dump, rtol =
    atol = 1e-4); under ``--ckpt-dir`` the checkpoint holds the logical
    factors (it restores onto one device) and a rerun resumes from it on
    every rank; ``--plan-cache`` is skipped with the reference's note."""
    dump = tmp_path / "mesh.npz"
    text = _mesh_cli(tmp_path, MESH_ARGS + argv + ["--dump-factors",
                                                   str(dump)])
    assert "backend=gloo" in text and "sweep   1" in text
    with np.load(dump) as z:
        got = [z[f"factor_{d}"] for d in range(3)]
    if "--plan-cache" in argv:
        assert "--plan-cache tuning skipped under --mesh" in text
        assert not (tmp_path / "plans.json").exists()
    if "--ckpt-dir" in argv:
        from repro_torch import checkpoint as ckpt
        like = {f"[{d}]": np.zeros_like(f) for d, f in enumerate(got)}
        step = ckpt.latest_step(str(tmp_path / "ck"))
        state, _ = ckpt.restore(str(tmp_path / "ck"), step,
                                [torch.zeros(f.shape) for f in got])
        assert step == 1 and len(like) == 3
        for g, s in zip(got, state):
            np.testing.assert_array_equal(s.numpy(), g)
        again = _mesh_cli(tmp_path, MESH_ARGS + argv + [
            "--dump-factors", str(tmp_path / "again.npz")])
        assert "all 2 sweeps restored" in again
        with np.load(tmp_path / "again.npz") as z:
            for d, g in enumerate(got):
                np.testing.assert_array_equal(z[f"factor_{d}"], g)
    if argv == ["--mesh", "2,1"]:
        local = complete.main(MESH_ARGS[:2] + MESH_ARGS[4:])
        for d, (g, w) in enumerate(zip(got, local.factors)):
            np.testing.assert_allclose(g, w.numpy(), err_msg=f"factor {d}",
                                       **TOL)


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2,1", "--device", "cuda"],
     r"needs 2 devices but only \d are visible; nccl takes one card per "
     r"rank: pass --dist-backend gloo"),
    (["--mesh", "2,1", "--device", "cpu"],
     r"on CPU pass --force-host-devices 2"),
    (["--mesh", "2,1", "--device", "cpu", "--force-host-devices", "2",
      "--dist-backend", "nccl"], r"nccl needs cards"),
    (["--mesh", "1,3", "--device", "cpu", "--force-host-devices", "3"],
     r"--rank 10 is not a multiple of the model axis size 3")])
def test_cli_refuses_a_mesh_it_cannot_run(argv, match):
    """Refused before any rank starts: more ranks than cards under nccl
    (the reference's "needs N devices" message, naming gloo), a CPU mesh
    without host ranks or over nccl, a rank the model axis does not
    divide."""
    with pytest.raises(SystemExit, match=match):
        complete.main(argv)


# the planner's matvec paths of the CLI (refused before the planner was
# ported); ggn runs one iteration, where float32 holds 1e-4
PLANNER_CLI_RUNS = [("ggn", "auto"), ("als", "auto"), ("ggn", "dense"),
                    ("ggn", "sliced"), ("als", "dense")]


@pytest.mark.slow
@pytest.mark.parametrize("algo,path", PLANNER_CLI_RUNS,
                         ids=[f"{a}-{p}" for a, p in PLANNER_CLI_RUNS])
def test_cli_planner_matvec_paths_match_reference(tmp_path, capsys, algo,
                                                  path):
    """``--matvec-path auto|sliced|dense`` from the reference's arrays
    (``--init-npz``) against the JAX package's sweep functions, called as
    its CLI calls them (ggn with the same ``matvec_path``)."""
    j, jo, jf, t, to, tf = _problem(3, seed=7)
    src = tmp_path / "init.npz"
    np.savez(src, indices=np.asarray(j.indices), values=np.asarray(j.values),
             valid=np.asarray(j.valid), shape=np.asarray(j.shape),
             **{f"factor_{d}": np.asarray(f) for d, f in enumerate(jf)})
    sweeps = 2 if algo == "als" else 1
    run = complete.main(["--device", "cpu", "--init-npz", str(src),
                         "--algorithm", algo, "--loss", "poisson_log",
                         "--sweeps", str(sweeps), "--cg-iters",
                         str(CG_ITERS), "--lam", str(LAM),
                         "--matvec-path", path])
    assert f"matvec_path={path}" in capsys.readouterr().out
    if algo == "als":
        want = _reference_sweeps("als", "quadratic", j, jf, sweeps)[0]
    else:
        # jitted, as the reference's CLI runs it (its eager ggn_sweep leaks
        # a tracer through the fused path's pattern cache)
        sweep = jax.jit(lambda s, stt: jggn.ggn_sweep(
            s, stt, jlosses.LOSSES["poisson_log"], LAM, cg_tol=CG_TOL,
            cg_iters=CG_ITERS, matvec_path=path))
        want = [list(sweep(j, jggn.ggn_init(jf, damping=1e-5)).factors)]
    for fs, w in zip(run.sweep_factors, want):
        _close(fs, w)


def test_cli_refuses_unknown_loss():
    """The reference's message, word for word."""
    with pytest.raises(SystemExit) as exc:
        complete.main(["--device", "cpu", "--algorithm", "gcp", "--loss",
                       "hinge"])
    assert str(exc.value) == (
        "unknown --loss hinge; choices: ['huber', 'logistic', 'poisson', "
        "'poisson_log', 'quadratic']")


# (algorithm, loss) of the CLI parity runs; gcp and ggn on a loss of their
# own, the others fit the quadratic loss
CLI_RUNS = [("als", "quadratic"), ("ccd", "quadratic"),
            ("ccd_tttp", "quadratic"), ("sgd", "quadratic"),
            ("gcp", "poisson_log"), ("ggn", "poisson_log")]


def _reference_sweeps(algo, loss_name, j, jf, sweeps):
    """The factors after each sweep of the JAX package's sweep functions,
    called as ``repro.launch.complete`` calls them (its defaults: lr 1e-3,
    sample rate 0.1, damping 1e-5, 15 joint and 8 preconditioner
    iterations), and the SGD samples they drew."""
    loss = jlosses.LOSSES[loss_name]
    key = jax.random.PRNGKey(0)
    out, samples = [], []
    if algo == "als":
        fs = jf
        for _ in range(sweeps):
            fs = jals.als_sweep(j, j.with_values(jnp.ones_like(j.values)), fs,
                                LAM, cg_tol=CG_TOL, cg_iters=CG_ITERS)
            out.append(fs)
    elif algo in ("ccd", "ccd_tttp"):
        sweep = jccd.ccd_sweep if algo == "ccd" else jccd.ccd_sweep_tttp
        fs, rho = jf, jccd.residual_values(j, jf)
        for _ in range(sweeps):
            fs, rho = sweep(j, fs, rho, LAM)
            out.append(fs)
    elif algo == "sgd":
        size, fs = max(1024, int(0.1 * j.nnz)), jf
        for i in range(sweeps):
            k = jax.random.fold_in(key, i)
            samples.append(jsgd.sample_entries(k, j, size))
            fs = jsgd.sgd_sweep(k, j, fs, LAM, 1e-3, size)
            out.append(fs)
    elif algo == "gcp":
        fs, state = jf, jgcp.gcp_adam_init(jf)
        for _ in range(sweeps):
            fs, state = jgcp.gcp_step(j, fs, loss, LAM, 1e-3, state)
            out.append(fs)
    else:
        state = jggn.ggn_init(jf, damping=1e-5)
        for _ in range(sweeps):
            state = jggn.ggn_sweep(j, state, loss, LAM, cg_tol=CG_TOL,
                                   cg_iters=CG_ITERS)
            out.append(list(state.factors))
    return out, samples


@pytest.mark.parametrize("algo,loss", CLI_RUNS, ids=[a for a, _ in CLI_RUNS])
def test_cli_runs_each_algorithm_like_the_reference(tmp_path, capsys,
                                                    monkeypatch, algo, loss):
    """Two sweeps of ``--algorithm`` from the reference's arrays
    (``--init-npz``) against the JAX package's sweep functions on the same
    arrays; SGD runs on the reference's own samples (jax.random cannot be
    reproduced in torch). rtol = atol = 1e-4, except ggn's second
    iteration, held at rtol = atol = 1e-3: its joint solve carries float32
    rounding (1.3e-4 here, with the CLI's ingest shuffle changing the
    summation order), and on such problems the reference's own float32 GGN
    lies 6e-4 from its float64 run after two iterations, while the two
    packages agree to 2e-10 in float64 (tests/test_torch_solvers.py)."""
    j, jo, jf, t, to, tf = _problem(3, seed=7)
    src = tmp_path / "init.npz"
    np.savez(src, indices=np.asarray(j.indices), values=np.asarray(j.values),
             valid=np.asarray(j.valid), shape=np.asarray(j.shape),
             **{f"factor_{d}": np.asarray(f) for d, f in enumerate(jf)})
    want, samples = _reference_sweeps(algo, loss, j, jf, 2)
    if samples:
        drawn = iter(samples)
        monkeypatch.setattr(
            sgd, "sample_entries",
            lambda gen, st, size: (lambda s: interop.sparse_from_numpy(
                s.indices, s.values, s.valid, st.shape, "cpu"))(next(drawn)))
    run = complete.main(["--device", "cpu", "--init-npz", str(src),
                         "--algorithm", algo, "--loss", loss, "--sweeps", "2",
                         "--cg-iters", str(CG_ITERS), "--lam", str(LAM)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sweep ")]
    assert len(lines) == 3 and all("rmse=" in ln for ln in lines)
    if algo in ("gcp", "ggn"):
        assert all("objective=" in ln for ln in lines)
        assert len(run.objective) == 3
        assert run.objective[2] <= run.objective[0]
    if algo == "ggn":
        assert all("damping=" in ln for ln in lines[1:])
    for i, fs in enumerate(run.sweep_factors):
        tol = dict(rtol=1e-3, atol=1e-3) if (algo, i) == ("ggn", 1) else TOL
        _close(fs, want[i], **tol)
    assert all(n == 0 for c in run.sweep_launches for n in c.values())


def test_cli_function_tensor_on_cpu(capsys):
    run = complete.main(["--device", "cpu", "--dims", "40,30,20", "--nnz",
                         "3000", "--rank", "5", "--sweeps", "2",
                         "--cg-iters", "8", "--seed", "1"])
    e = [run.rmse0] + [h[2] for h in run.history]
    assert all(np.isfinite(e)) and e[2] < e[0]
    assert run.dataset.tensor.nnz == 3000
    assert [f.shape for f in run.factors] == [(40, 5), (30, 5), (20, 5)]
    assert os.path.basename(complete.__file__) == "complete.py"
