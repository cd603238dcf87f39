"""Parity of the PyTorch port's serving layer (``repro_torch.serve``) with
the JAX package's (``repro.serve``), on the CPU, on the same numpy factors
and histories made from a seed.

Tolerances, the reference's own: scores rtol = atol = 1e-6 (one float32
gather chain against another); top-k values to float32 rounding (rtol
1e-6) with indices equal (the random scores have no ties); fold-in rows
1e-4 against the reference's fold-in and against an explicit one-row solve
(two CG runs in float32 on differently ordered sums)."""
import inspect
import os
import pkgutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import serve as jserve
from repro.launch import complete as jcomplete

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

import repro_torch  # noqa: E402
from repro_torch import interop, obs, serve  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve_complete  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402

SHAPE = (30, 24, 10)
RANK = 6
TOL = dict(rtol=1e-6, atol=1e-6)
FOLD_TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(seed=0, shape=SHAPE, rank=RANK):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((s, rank)) / np.sqrt(rank))
            .astype(np.float32) for s in shape]


def _queries(rng, n, shape=SHAPE):
    return np.stack([rng.integers(0, s, size=n) for s in shape],
                    axis=1).astype(np.int32)


def _histories(rng, mode, users, nnz, shape=SHAPE):
    others = [d for d in range(len(shape)) if d != mode]
    return [(np.stack([rng.integers(0, shape[d], size=nnz) for d in others],
                      axis=1).astype(np.int32),
             rng.standard_normal(nnz).astype(np.float32))
            for _ in range(users)]


def _explicit(arrays, histories, mode, lam):
    fs = [a.astype(np.float64) for a in arrays]
    return serve_complete.oracle_foldin(fs, histories, mode, lam)


@pytest.fixture(scope="module")
def models():
    """The same factors as a reference and a port model, per link."""
    arrays = _arrays()
    return {link: (jserve.ServingModel([jnp.asarray(a) for a in arrays],
                                       link=link),
                   interop.serving_model_from_numpy(arrays, link,
                                                    device="cpu"))
            for link in ("identity", "log")}


@pytest.fixture(scope="module")
def engines(models):
    return {link: (jserve.ServeEngine(j, max_batch=64, min_batch=8),
                   serve.ServeEngine(t, max_batch=64, min_batch=8,
                                     device="cpu"))
            for link, (j, t) in models.items()}


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link", ["identity", "log"])
@pytest.mark.parametrize("n", [1, 8, 9, 33, 64, 200])
def test_score_matches_reference_at_every_bucket(engines, link, n):
    """Buckets 8, 16, 32 and 64 (max_batch), and 200 in chunks of 64."""
    jeng, teng = engines[link]
    idx = _queries(np.random.default_rng(n), n)
    got, want = teng.score(idx), jeng.score(idx)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    fs = serve_complete.host_factors(teng.model)
    np.testing.assert_allclose(got, serve_complete.oracle_scores(fs, idx,
                                                                 link),
                               **TOL)


def test_raw_scores_and_predict(models, engines):
    jm, tm = models["log"]
    idx = _queries(np.random.default_rng(5), 40)
    np.testing.assert_allclose(tm.raw_scores(torch.from_numpy(idx)).numpy(),
                               np.asarray(jm.raw_scores(jnp.asarray(idx))),
                               **TOL)
    np.testing.assert_allclose(tm.predict(torch.from_numpy(idx)).numpy(),
                               np.asarray(jm.predict(jnp.asarray(idx))),
                               **TOL)
    jeng, teng = engines["log"]
    np.testing.assert_allclose(teng.score(idx, link=False),
                               jeng.score(idx, link=False), **TOL)
    with pytest.raises(ValueError, match="expects"):
        teng.score(idx[:, :2])


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link", ["identity", "log"])
@pytest.mark.parametrize("target,k,block", [(0, 5, 8), (1, 7, 16),
                                            (2, 50, 4)])
def test_topk_matches_reference_and_full_sort(models, link, target, k,
                                              block):
    """J not a multiple of the block (30 by 8, 10 by 4); k = 50 clamped to
    J = 10."""
    jm, tm = models[link]
    rng = np.random.default_rng(target)
    fixed = {d: rng.integers(0, SHAPE[d], size=6)
             for d in range(3) if d != target}
    tq = serve.query_rows(tm.factors, fixed)
    jq = jserve.query_rows(jm.factors, {d: jnp.asarray(v)
                                        for d, v in fixed.items()})
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    tv, ti = serve.topk_over_mode(tm.factors[target], tq, k,
                                  block_rows=block, link=link)
    jv, ji = jserve.topk_over_mode(jm.factors[target], jq, k,
                                   block_rows=block, link=link)
    kk = min(k, SHAPE[target])
    assert tv.shape == ti.shape == (6, kk) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    full = tq.numpy().astype(np.float64) @ \
        tm.factors[target].numpy().astype(np.float64).T
    order = np.argsort(-full, axis=1, kind="stable")[:, :kk]
    np.testing.assert_array_equal(ti.numpy(), order)
    want = np.take_along_axis(full, order, 1)
    if link == "log":
        want = np.exp(want)
    np.testing.assert_allclose(tv.numpy(), want, **TOL)


def test_engine_topk_with_foldin_rows(engines):
    """top_k over items for users given as fresh fold-in rows, against the
    reference engine; the fixed-mode checks of the reference."""
    jeng, teng = engines["identity"]
    rng = np.random.default_rng(3)
    hists = _histories(rng, 0, 5, 12)
    rows = teng.fold_in(hists, 0)
    days = rng.integers(0, SHAPE[2], size=5)
    tv, ti = teng.top_k({0: rows, 2: days}, 1, 4)
    jv, ji = jeng.top_k({0: rows, 2: days}, 1, 4)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_array_equal(ti, ji)
    with pytest.raises(ValueError, match="cannot be fixed"):
        teng.top_k({1: days}, 1, 3)
    with pytest.raises(ValueError, match="disagree"):
        teng.top_k({0: days, 2: days[:3]}, 1, 3)
    with pytest.raises(ValueError, match="at least one"):
        serve.query_rows(teng.model.factors, {})


# ---------------------------------------------------------------------------
# fold-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matvec_path", [None, "tttp_mttkrp"])
def test_fold_in_matches_reference_and_explicit_solve(models, matvec_path):
    jm, tm = models["identity"]
    arrays = [f.numpy() for f in tm.factors]
    hists = _histories(np.random.default_rng(11), 0, 13, 20)
    st = serve.pack_histories(hists, SHAPE, 0, device="cpu")
    jst = jserve.pack_histories(hists, SHAPE, 0)
    rows, iters = serve.fold_in(st, tm.factors, 0, lam=0.05,
                                matvec_path=matvec_path)
    jrows, jiters = jserve.fold_in(jst, jm.factors, 0, lam=0.05,
                                   matvec_path=matvec_path)
    assert rows.shape == (13, RANK) and iters.dim() == 0
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), **FOLD_TOL)
    np.testing.assert_allclose(rows.numpy(),
                               _explicit(arrays, hists, 0, 0.05), **FOLD_TOL)
    # the trip count: iterations in which some row was still active
    assert 0 < int(iters) <= max(4 * RANK, 32)
    assert abs(int(iters) - int(jiters)) <= 2


def test_fold_in_nonzero_mode_single_and_weights(models):
    jm, tm = models["identity"]
    arrays = [f.numpy() for f in tm.factors]
    hists = _histories(np.random.default_rng(12), 2, 4, 15)
    st = serve.pack_histories(hists, SHAPE, 2, device="cpu")
    rows, _ = serve.fold_in(st, tm.factors, 2)
    np.testing.assert_allclose(rows.numpy(),
                               _explicit(arrays, hists, 2, 1e-2), **FOLD_TOL)
    one = serve.fold_in_single(tm.factors, 2, hists[1][0], hists[1][1],
                               SHAPE)
    jone = jserve.fold_in_single(jm.factors, 2, hists[1][0], hists[1][1],
                                 SHAPE)
    np.testing.assert_allclose(one.numpy(), rows[1].numpy(), **FOLD_TOL)
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), **FOLD_TOL)
    # per-entry weights ω, against the reference's weighted fold-in
    w = np.random.default_rng(4).uniform(0.5, 2.0, st.cap).astype(np.float32)
    jst = jserve.pack_histories(hists, SHAPE, 2)
    wrows, _ = serve.fold_in(st, tm.factors, 2, weights=torch.from_numpy(w))
    jw, _ = jserve.fold_in(jst, jm.factors, 2, weights=jnp.asarray(w))
    np.testing.assert_allclose(wrows.numpy(), np.asarray(jw), **FOLD_TOL)


@pytest.mark.parametrize("path", ["sliced", "dense", "auto"])
def test_planner_paths_raise(models, path):
    _, tm = models["identity"]
    st = serve.pack_histories(_histories(np.random.default_rng(1), 0, 2, 4),
                              SHAPE, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="planner"):
        serve.fold_in(st, tm.factors, 0, matvec_path=path)
    with pytest.raises(NotImplementedError, match="planner"):
        serve.ServeEngine(tm, foldin_matvec_path=path, device="cpu")
    with pytest.raises(NotImplementedError, match="planner"):
        serve.ServeEngine(tm, score_path="all_at_once", device="cpu")


@pytest.mark.parametrize("users", [3, 70])
def test_engine_fold_in_matches_reference_engine(engines, users):
    """70 users pass max_batch (64): two batches, each padded to its
    bucket with empty histories; obs counts the users."""
    jeng, teng = engines["identity"]
    hists = _histories(np.random.default_rng(users), 0, users, 9)
    def counted():
        return obs.get_registry().summary()["counters"].get(
            "serve/foldin_users", 0)

    obs.enable()
    try:
        before = counted()
        rows = teng.fold_in(hists, 0)
        users_counted = counted() - before
    finally:
        obs.disable()
    assert rows.shape == (users, RANK) and rows.dtype == np.float32
    np.testing.assert_allclose(rows, jeng.fold_in(hists, 0), **FOLD_TOL)
    arrays = [f.numpy() for f in teng.model.factors]
    np.testing.assert_allclose(rows, _explicit(arrays, hists, 0, 1e-2),
                               **FOLD_TOL)
    assert users_counted == users


def test_pack_histories_bounds_and_model_validation(models):
    _, tm = models["identity"]
    bad = [(np.array([[0, 99]], np.int32), np.array([1.0], np.float32))]
    with pytest.raises(ValueError, match="out of range"):
        serve.pack_histories(bad, SHAPE, 0, device="cpu")
    st = serve.pack_histories(_histories(np.random.default_rng(2), 1, 3, 5),
                              SHAPE, 1, device="cpu")
    assert st.shape == (30, 3, 10) and st.cap == 16 and st.nnz == 15
    assert st.device.type == "cpu"
    with pytest.raises(ValueError, match="at least one"):
        serve.ServingModel([])
    with pytest.raises(ValueError, match="rank"):
        serve.ServingModel([torch.zeros(3, 2), torch.zeros(4, 3)])
    with pytest.raises(ValueError, match="link"):
        serve.ServingModel([torch.zeros(3, 2)], link="sigmoid")
    with pytest.raises(ValueError, match="link"):
        serve.apply_link(torch.zeros(2), "sigmoid")
    assert (tm.shape, tm.rank, tm.ndim) == (SHAPE, RANK, 3)
    # the engine refuses factors that are not on its device
    with pytest.raises(ValueError, match="factor 0 is on cpu"):
        serve.ServeEngine(tm)


def test_percentiles_match_reference():
    xs = list(np.random.default_rng(0).uniform(1e-4, 3e-3, 257))
    assert serve.percentiles(xs) == jserve.percentiles(xs)
    assert serve.percentiles([]) == {}
    for n, lo, hi in ((1, 64, 4096), (65, 64, 4096), (5000, 64, 4096)):
        assert serve_engine._bucket(n, lo, hi) == \
            jserve.engine._bucket(n, lo, hi)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

CLI_DIMS = "24,20,16"


@pytest.fixture(scope="module")
def reference_dump(tmp_path_factory):
    """A factor checkpoint that the reference's CLI dumped (in-process)."""
    tmp = tmp_path_factory.mktemp("jdump")
    out = str(tmp / "factors")
    argv = sys.argv
    sys.argv = ["complete", "--dims", CLI_DIMS, "--nnz", "2000", "--rank",
                "4", "--sweeps", "1", "--cg-iters", "5", "--ckpt-dir",
                str(tmp / "ck"), "--dump-factors", out]
    try:
        jcomplete.main()
    finally:
        sys.argv = argv
    return out


def test_load_factors_of_a_reference_checkpoint(reference_dump):
    jm = jserve.load_factors(reference_dump)
    tm = serve.load_factors(reference_dump, device="cpu")
    assert tm.shape == jm.shape == (24, 20, 16) and tm.rank == 4
    assert tm.meta == jm.meta and tm.link == jm.link == "identity"
    for f, jf in zip(tm.factors, jm.factors):
        assert f.device.type == "cpu" and f.dtype == torch.float32
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert serve.load_factors(reference_dump, link="log",
                              device="cpu").link == "log"
    idx = _queries(np.random.default_rng(9), 100, tm.shape)
    np.testing.assert_allclose(
        serve.ServeEngine(tm, device="cpu").score(idx),
        jserve.ServeEngine(jm).score(idx), **TOL)


def test_load_factors_npz_and_refusals(tmp_path):
    arrays = _arrays(1)
    path = str(tmp_path / "f.npz")
    np.savez(path, **{f"factor_{d}": a for d, a in enumerate(arrays)},
             other=np.zeros(3))
    tm = serve.load_factors(path, device="cpu")
    assert tm.link == "identity" and tm.meta == {}
    for f, a in zip(tm.factors, arrays):
        np.testing.assert_array_equal(f.numpy(), a)
    np.savez(str(tmp_path / "g.npz"), factor_0=arrays[0], factor_2=arrays[2])
    with pytest.raises(ValueError, match="contiguous"):
        serve.load_factors(str(tmp_path / "g.npz"), device="cpu")
    np.savez(str(tmp_path / "h.npz"), weights=arrays[0])
    with pytest.raises(ValueError, match="no factor_"):
        serve.load_factors(str(tmp_path / "h.npz"), device="cpu")
    # a checkpoint of something else, written by the reference
    jckpt.save(str(tmp_path / "ck"), 3, {"w": jnp.zeros((3, 2))})
    with pytest.raises(ValueError, match="not a factor checkpoint"):
        serve.load_factors(str(tmp_path / "ck"), device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no committed"):
        serve.load_factors(str(tmp_path / "empty"), device="cpu")
    # a port checkpoint with its metadata's link, at a chosen step
    ckpt.save(str(tmp_path / "pk"), 4,
              {f"factor_{d}": torch.from_numpy(a)
               for d, a in enumerate(arrays)}, metadata={"link": "log"})
    ckpt.save(str(tmp_path / "pk"), 6,
              {f"factor_{d}": torch.from_numpy(2 * a)
               for d, a in enumerate(arrays)}, metadata={"link": "log"})
    got = serve.load_factors(str(tmp_path / "pk"), step=4, device="cpu")
    assert got.link == "log"
    np.testing.assert_array_equal(got.factors[1].numpy(), arrays[1])


def test_serve_complete_verify_on_a_reference_checkpoint(reference_dump,
                                                         tmp_path, capsys):
    out = str(tmp_path / "report.json")
    report = serve_complete.main([
        "--factors", reference_dump, "--device", "cpu", "--num-queries",
        "3000", "--batch-size", "256", "--topk", "5", "--topk-users", "7",
        "--foldin-users", "9", "--foldin-nnz", "12", "--verify", "--json",
        out])
    text = capsys.readouterr().out
    assert "verify OK" in text
    assert set(report) == {"shape", "rank", "link", "batch_size", "score",
                           "topk", "foldin"}
    assert report["score"]["calls"] == 12 and report["score"]["qps"] > 0
    assert os.path.exists(out)
    with pytest.raises(NotImplementedError, match="planner"):
        serve_complete.main(["--factors", reference_dump, "--device", "cpu",
                             "--matvec-path", "sliced"])


def test_verify_catches_a_wrong_score(reference_dump):
    """The score check compares with an independent float64 oracle, not
    with the kernel itself: a perturbed score fails it."""
    tm = serve.load_factors(reference_dump, device="cpu")
    fs = serve_complete.host_factors(tm)
    idx = _queries(np.random.default_rng(2), 50, tm.shape)
    scores = serve.ServeEngine(tm, device="cpu").score(idx)
    err, lim = serve_complete.verify_scores(fs, idx, scores, tm.link)
    assert err <= lim
    scores[7] += 1e-5
    err, lim = serve_complete.verify_scores(fs, idx, scores, tm.link)
    assert err > lim


# ---------------------------------------------------------------------------
# port invariants
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda():
    """Every function of the port with a ``device`` parameter defaults to
    the card, but ``SparseTensor.from_coo`` (None keeps its inputs'
    device), and every CLI's ``--device`` does."""
    found = []
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        mod = __import__(info.name, fromlist=["_"])
        for _, obj in inspect.getmembers(mod):
            fns = [obj] if inspect.isfunction(obj) else (
                [m for _, m in inspect.getmembers(obj, inspect.isfunction)]
                + [m.__func__ for _, m in inspect.getmembers(
                    obj, inspect.ismethod)]
                if inspect.isclass(obj) else [])
            for fn in fns:
                if not fn.__module__.startswith("repro_torch"):
                    continue
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not p.empty:
                    found.append((fn.__qualname__, p.default))
    found = sorted(set(found))
    assert [f for f in found if f[1] != "cuda"] == \
        [("SparseTensor.from_coo", None)]
    names = {f[0] for f in found}
    assert {"load_factors", "pack_histories", "ServeEngine.__init__",
            "serving_model_from_numpy", "ingest_spec"} <= names
    from repro_torch.launch import complete, experiment
    for m in (complete, experiment, serve_complete):
        args = m.build_parser().parse_args(
            ["--factors", "x"] if m is serve_complete else [])
        assert args.device == "cuda", m.__name__


def test_recorded_launches_moves_counts_to_the_replay():
    """What the wrappers count inside a capture comes back out of the
    counts, and each replay adds it again."""
    kops.reset_launch_counts()
    try:
        with kops.recorded_launches() as held:
            kops.ktttp.launches += 1
            kops.kcg.launches += 3
        assert kops.launch_counts() == {"tttp": 0, "mttkrp": 0,
                                        "cg_matvec": 0}
        assert held == {"tttp": 1, "mttkrp": 0, "cg_matvec": 3}
        for _ in range(4):
            kops.add_launches(held)
        assert kops.launch_counts() == {"tttp": 4, "mttkrp": 0,
                                        "cg_matvec": 12}
    finally:
        kops.reset_launch_counts()
