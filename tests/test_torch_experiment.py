"""The PyTorch port's experiment harness and checkpointed CLI against the
JAX package's.

Both packages stream ``netflix-ci`` to the same tensors (its generator seeds
numpy alone), so ``make_solver``'s steps are held on identical data from
shared factors: ALS and CCD++ at the reference's float32 tolerance,
rtol = atol = 1e-4, and one GGN iteration (``poisson_log``, the log link)
in float64 at 1e-8, where the two packages' sums agree to far below it and
the line search's discrete choices must match (float32 GGN iterations
differ between any two summation orders by 3e-4 or more; see
``tests/test_torch_solvers.py``). The port runs on the CPU."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.data import streaming as jstreaming
from repro.data.pipeline import CompletionDataset as JCompletionDataset
from repro.launch import experiment as jexperiment

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.data import streaming  # noqa: E402
from repro_torch.data.pipeline import CompletionDataset  # noqa: E402
from repro_torch.launch import complete, experiment  # noqa: E402
from repro_torch.runtime import fault_tolerance  # noqa: E402

CI = experiment.SPECS["netflix-ci"]
TINY = experiment.ExperimentSpec(
    "tiny-test", "netflix", (40, 30, 10), nnz=5_000, chunk_size=1_500,
    rank=4, sweeps=5, test_fraction=0.15, lam=1e-4, seed=0)


def test_specs_equal_reference():
    assert experiment.ALGORITHMS == jexperiment.ALGORITHMS
    assert experiment.SPECS.keys() == jexperiment.SPECS.keys()
    for name, spec in experiment.SPECS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(jexperiment.SPECS[name]), name


def _datasets(spec):
    def chunks(mod):
        return mod.make_stream(spec.dataset, spec.seed, spec.shape, spec.nnz,
                               spec.chunk_size, zipf_a=spec.zipf_a)
    jds = JCompletionDataset.from_stream(
        chunks(jstreaming), spec.shape, num_shards=spec.num_shards,
        test_fraction=spec.test_fraction, bucket_modes=())
    ds = CompletionDataset.from_stream(
        chunks(streaming), spec.shape, num_shards=spec.num_shards,
        test_fraction=spec.test_fraction, device="cpu")
    assert np.array_equal(ds.tensor.values.numpy(),
                          np.asarray(jds.tensor.values))
    return jds, ds


def _factors(spec, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((d, spec.rank)) / np.sqrt(spec.rank))
            .astype(np.float32) for d in spec.shape]


@pytest.mark.parametrize("algorithm", ["als", "ccd"])
def test_make_solver_steps_match_reference(algorithm):
    jds, ds = _datasets(CI)
    fs = _factors(CI)
    jstate, jstep, jget, jupd, jlink = jexperiment.make_solver(
        algorithm, "poisson_log", jds.tensor, jds.omega,
        [jnp.asarray(f) for f in fs], CI)
    state, step, get, upd, link = experiment.make_solver(
        algorithm, "poisson_log", ds.tensor, ds.omega,
        [torch.from_numpy(f) for f in fs], CI)
    assert (upd, link) == (jupd, jlink) == ("quadratic", "identity")
    for i in range(2):
        jstate, state = jstep(i, jstate), step(i, state)
        for d, (g, w) in enumerate(zip(get(state), jget(jstate))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4,
                                       err_msg=f"sweep {i} factor {d}")


def test_make_solver_ggn_poisson_log_iteration_matches_reference():
    jds, ds = _datasets(CI)
    fs = [f.astype(np.float64) for f in _factors(CI, seed=6)]
    with jax.enable_x64(True):
        j = jds.tensor
        j64 = JSparseTensor(j.indices, jnp.asarray(j.values, jnp.float64),
                            j.valid, j.shape, j.nnz)
        t64 = ds.tensor.with_values(ds.tensor.values.double())
        jstate, jstep, jget, jupd, jlink = jexperiment.make_solver(
            "ggn", "poisson_log", j64, None, [jnp.asarray(f) for f in fs],
            CI)
        state, step, get, upd, link = experiment.make_solver(
            "ggn", "poisson_log", t64, None,
            [torch.from_numpy(f) for f in fs], CI)
        assert (upd, link) == (jupd, jlink) == ("poisson_log", "log")
        assert float(state.damping) == float(jstate.damping) == 10.0
        jstate, state = jstep(0, jstate), step(0, state)
        assert float(state.damping) == float(jstate.damping)
        for d, (g, w) in enumerate(zip(get(state), jget(jstate))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                       atol=1e-8, err_msg=f"factor {d}")


def test_make_solver_link_and_damping_defaults():
    _, ds = _datasets(TINY)
    fs = [torch.zeros(d, TINY.rank) for d in TINY.shape]
    for algorithm in experiment.ALGORITHMS:
        for loss in ("quadratic", "poisson_log", "huber"):
            state, _, _, upd, link = experiment.make_solver(
                algorithm, loss, ds.tensor, ds.omega, fs, TINY)
            native = algorithm in ("ggn", "gcp")
            assert upd == (loss if native else "quadratic")
            assert link == ("log" if native and loss == "poisson_log"
                            else "identity")
            if algorithm == "ggn":
                want = 10.0 if loss == "poisson_log" else 1e-5
                assert float(state.damping) == pytest.approx(want)
    with pytest.raises(ValueError, match="unknown algorithm"):
        experiment.make_solver("lbfgs", "quadratic", ds.tensor, ds.omega, fs,
                               TINY)


def _keys(report):
    return (set(report), set(report["spec"]), set(report["ingest"]),
            set(report["runs"][0]), set(report["runs"][0]["sweeps"][0]))


def test_run_experiment_netflix_ci_every_pair(tmp_path):
    """Every (algorithm, loss) pair of netflix-ci runs on the CPU; the
    report has the reference's keys (plus each run's ``launches``) and
    finite metrics, and matches its JSON file."""
    spec = dataclasses.replace(CI, sweeps=2)
    jreport = jexperiment.run_experiment(
        dataclasses.replace(TINY, sweeps=1), out_dir=str(tmp_path / "j"),
        algorithms=("als",), losses=("quadratic",))
    report = experiment.run_experiment(
        spec, out_dir=str(tmp_path / "p"), algorithms=experiment.ALGORITHMS,
        device="cpu")
    with open(tmp_path / "p" / "experiment_netflix-ci.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    got, want = _keys(report), _keys(jreport)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert got[3] == want[3] | {"launches"}
    assert got[4] == want[4]
    pairs = [(r["algorithm"], r["loss"]) for r in report["runs"]]
    assert pairs == [(a, l) for l in spec.losses for a in experiment.ALGORITHMS]
    for run in report["runs"]:
        assert [e["sweep"] for e in run["sweeps"]] == [0, 1]
        assert run["final"] == run["sweeps"][-1]
        assert run["launches"] == {"tttp": 0, "mttkrp": 0, "cg_matvec": 0}
        for e in run["sweeps"]:
            for k in ("objective", "rmse_train", "rmse_test",
                      "poisson_deviance_test", "seconds"):
                assert np.isfinite(e[k]), (run["algorithm"], run["loss"], k)
    ing = report["ingest"]
    assert ing["nnz"] + ing["duplicates_dropped"] == ing["entries_read"]


def test_run_experiment_refuses_plan_cache(tmp_path, monkeypatch, capsys):
    """Named for the refusal the kernel-tile tuner replaced: a plan cache,
    given as ``plan_cache=`` or by ``REPRO_PLAN_CACHE``, now tunes the
    tiles before the first run, and the second experiment on the same
    spec restores every family from the file."""
    from repro_torch.kernels import tile as ktile
    from repro_torch.planner import cost as pcost
    spec = dataclasses.replace(TINY, sweeps=1)
    cache = str(tmp_path / "plans.json")
    kw = dict(algorithms=("als",), losses=("quadratic",), device="cpu")
    try:
        first = experiment.run_experiment(spec, out_dir=str(tmp_path / "a"),
                                          plan_cache=cache, **kw)
        monkeypatch.setenv("REPRO_PLAN_CACHE", cache)
        second = experiment.run_experiment(spec,
                                           out_dir=str(tmp_path / "b"), **kw)
    finally:
        ktile.reset_tiles()
        pcost.reset_rates()
    assert first["plan_cache"]["hits"] == 0
    assert first["plan_cache"]["measured"] > 0
    assert second["plan_cache"] == {**first["plan_cache"], "hits": 3,
                                    "measured": 0}
    assert capsys.readouterr().out.count("plan-cache: hits=") == 2


def test_experiment_resumes_metrics_from_manifest(tmp_path, monkeypatch):
    """Kill the loop after sweep 4; the rerun resumes from the checkpoint
    and rebuilds the earlier sweeps' metrics from the manifest; a rerun of
    the finished experiment runs nothing and keeps the history."""
    spec = dataclasses.replace(TINY, sweeps=7)
    ckpt_root = str(tmp_path / "ckpt")
    orig_run = fault_tolerance.RestartableLoop.run

    def failing_run(self, init_state, num_steps, fail_at=None):
        return orig_run(self, init_state, num_steps, fail_at=4)

    kw = dict(out_dir=str(tmp_path), ckpt_root=ckpt_root, algorithms=("als",),
              losses=("quadratic",), device="cpu")
    monkeypatch.setattr(fault_tolerance.RestartableLoop, "run", failing_run)
    with pytest.raises(RuntimeError, match="injected failure"):
        experiment.run_experiment(spec, **kw)
    monkeypatch.setattr(fault_tolerance.RestartableLoop, "run", orig_run)
    report = experiment.run_experiment(spec, **kw)
    (run,) = report["runs"]
    assert [e["sweep"] for e in run["sweeps"]] == list(range(7))
    report2 = experiment.run_experiment(spec, **kw)
    (run2,) = report2["runs"]
    assert [e["sweep"] for e in run2["sweeps"]] == list(range(7))
    assert run2["sweeps"][:5] == run["sweeps"][:5]
    rmses = [e["rmse_test"] for e in run["sweeps"]]
    assert rmses[-1] < 0.8 * rmses[0]


CLI = ["--device", "cpu", "--dims", "30,20,10", "--nnz", "2500", "--rank",
       "4", "--cg-iters", "8"]


@pytest.mark.parametrize("algorithm", ["als", "sgd", "ggn"])
def test_complete_ckpt_dir_resumes(algorithm, tmp_path):
    """``--ckpt-dir`` resumes where the last run stopped and ends where an
    uninterrupted run ends (SGD's sample depends on the sweep alone); a run
    with nothing left restores its factors and runs no sweep."""
    argv = CLI + ["--algorithm", algorithm]
    ck = ["--ckpt-dir", str(tmp_path / "ck")]
    whole = complete.main(argv + ["--sweeps", "5"])
    first = complete.main(argv + ["--sweeps", "3"] + ck)
    assert [h[0] for h in first.history] == [0, 1, 2]
    rest = complete.main(argv + ["--sweeps", "5"] + ck)
    assert [h[0] for h in rest.history] == [3, 4]
    done = complete.main(argv + ["--sweeps", "5"] + ck)
    assert done.history == []
    for a, b, c in zip(rest.factors, whole.factors, done.factors):
        assert torch.equal(a, b) and torch.equal(c, b)


def test_complete_netflix_dataset():
    run = complete.main(CLI + ["--dataset", "netflix", "--sweeps", "2"])
    st = run.dataset.tensor
    assert st.nnz == 2500
    vals = st.values[st.valid]
    assert float(vals.min()) >= 1.0 and float(vals.max()) <= 5.0
    assert run.history[-1][2] < run.rmse0
    with pytest.raises(SystemExit, match="three sizes"):
        complete.main(CLI[:2] + ["--dataset", "netflix", "--dims", "30,20"])
