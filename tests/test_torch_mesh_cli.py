"""``repro_torch.launch.complete --mesh`` end to end: every algorithm on a
grid of gloo ranks on the CPU (``--device cpu --force-host-devices 8``)
against the JAX package's LOCAL sweep functions on the same arrays, with
``tests/test_complete_cli.py``'s cases and sizes (its mesh runs are no
oracle on this jax: they stop at the reference's eager RMSE gather).

The CLI starts from the arrays through ``--init-npz`` (4000 entries and no
padding, a multiple of every data-axis size, so the ingest shuffle is the
LOCAL one) and runs as a subprocess, which spawns its ranks; rank 0 dumps
the gathered factors. SGD draws its samples in torch, which the reference
cannot: the reference is fed the samples the port's ingest draws (on a
data axis of size 1 each rank draws the LOCAL sample). rtol = atol = 1e-4,
the reference test's, for every algorithm (GGN too: at 30 CG iterations to
a 1e-7 residual its float32 run holds it here)."""
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

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.core.completion import fold_seed  # noqa: E402
from repro_torch.core.completion import sgd  # noqa: E402
from repro_torch.launch import complete  # noqa: E402

_DIMS = (24, 20, 16)
_NNZ = 4000
_COMMON = ["--sweeps", "2", "--cg-iters", "30", "--cg-tol", "1e-7"]
LAM, LR, DAMPING = 1e-5, 1e-3, 1e-5

# tests/test_complete_cli.py's (algorithm, mesh, rank): sgd keeps the data
# axis at size 1 and runs on the model axis; the rank divides the model axis
CASES = [
    ("als", "4,2", 4),
    ("ccd", "4,2", 4),
    ("ccd_tttp", "4,2", 4),
    ("sgd", "1,8", 8),
    ("gcp", "4,2", 4),
    ("ggn", "4,2", 4),
]


def _arrays(r, seed=0):
    """A function-tensor sample of ``_NNZ`` entries (no padding) and
    N(0, 1/R) factors."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, _NNZ) for s in _DIMS], 1) \
        .astype(np.int32)
    grids = [rng.uniform(-1, 1, s) for s in _DIMS]
    vals = (1 / (1 + np.exp(-3 * sum(g[idx[:, d]] for d, g in
                                     enumerate(grids))))).astype(np.float32)
    fs = [(rng.standard_normal((s, r)) / np.sqrt(r)).astype(np.float32)
          for s in _DIMS]
    return idx, vals, np.ones(_NNZ, bool), fs


def _cli(tmp_path, tag, argv):
    dump = tmp_path / f"{tag}.npz"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(PORT))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.complete", *argv,
         "--dump-factors", str(dump)], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + "\n---\n" + \
        out.stderr[-6000:]
    with np.load(dump) as z:
        return [z[f"factor_{d}"] for d in range(3)], out.stdout


def _port_samples(argv, sweeps):
    """The samples the port's SGD draws on the ingested tensor (LOCAL, and
    so on a data axis of size 1), as the reference's SparseTensors."""
    args = complete.build_parser().parse_args(argv)
    ds, _ = complete.load_problem(args)
    size = max(1024, int(args.sample_rate * ds.global_nnz))
    gen = torch.Generator()
    out = []
    for i in range(sweeps):
        s = sgd.sample_entries(gen.manual_seed(fold_seed(args.seed, i)),
                               ds.tensor, size)
        out.append(JSparseTensor(jnp.asarray(s.indices.numpy()),
                                 jnp.asarray(s.values.numpy()),
                                 jnp.asarray(s.valid.numpy()), s.shape,
                                 size))
    return out


def _reference(algo, idx, vals, valid, fs, samples):
    """The factors after two sweeps of the JAX package's LOCAL sweep
    functions, called as its CLI calls them (its defaults)."""
    j = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(valid),
                      _DIMS, _NNZ)
    fs = [jnp.asarray(f) for f in fs]
    loss = jlosses.LOSSES["quadratic"]
    if algo == "als":
        sweep = jax.jit(lambda s, o, f: tuple(jals.als_sweep(
            s, o, list(f), LAM, cg_tol=1e-7, cg_iters=30)))
        omega = j.with_values(jnp.ones_like(j.values))
        for _ in range(2):
            fs = sweep(j, omega, tuple(fs))
        return list(fs)
    if algo in ("ccd", "ccd_tttp"):
        sweep = jccd.ccd_sweep if algo == "ccd" else jccd.ccd_sweep_tttp
        rho = jccd.residual_values(j, fs)
        for _ in range(2):
            fs, rho = sweep(j, fs, rho, LAM)
        return fs
    if algo == "sgd":
        drawn = iter(samples)
        real = jsgd.sample_entries
        jsgd.sample_entries = lambda key, st, size: next(drawn)
        try:
            for i in range(2):
                fs = jsgd.sgd_sweep(jax.random.PRNGKey(i), j, fs, LAM, LR,
                                    1024)
        finally:
            jsgd.sample_entries = real
        return fs
    if algo == "gcp":
        state = jgcp.gcp_adam_init(fs)
        for _ in range(2):
            fs, state = jgcp.gcp_step(j, fs, loss, LAM, LR, state)
        return fs
    step = jax.jit(lambda s, g: jggn.ggn_sweep(s, g, loss, LAM, cg_tol=1e-7,
                                               cg_iters=30))
    state = jggn.ggn_init(fs, damping=DAMPING)
    for _ in range(2):
        state = step(j, state)
    return list(state.factors)


@pytest.mark.parametrize("algo,mesh,rank", CASES, ids=[c[0] for c in CASES])
def test_mesh_run_matches_local_reference(tmp_path, algo, mesh, rank):
    idx, vals, valid, fs = _arrays(rank)
    src = tmp_path / "init.npz"
    np.savez(src, indices=idx, values=vals, valid=valid,
             shape=np.array(_DIMS),
             **{f"factor_{d}": f for d, f in enumerate(fs)})
    base = ["--algorithm", algo, "--init-npz", str(src), "--device", "cpu",
            "--rank", str(rank), *_COMMON]
    got, text = _cli(tmp_path, "mesh", base + ["--mesh", mesh,
                                               "--force-host-devices", "8"])
    assert f"mesh={{'data': {mesh[0]}, 'model': {mesh[2]}}}" in text
    assert "sweep   1" in text and "backend=gloo" in text
    samples = _port_samples(base, 2) if algo == "sgd" else None
    want = _reference(algo, idx, vals, valid, fs, samples)
    for d, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{algo} factor {d}")
