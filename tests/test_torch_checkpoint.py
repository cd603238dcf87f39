"""The PyTorch port's checkpointer and restartable loop, against the JAX
package's on-disk format.

The two packages must name every leaf alike (``_leaf_paths``) and restore
each other's checkpoints bit for bit, ``--dump-factors DIR`` included. The
reference's three checkpoint regressions (an async error swallowed,
``keep_last=0`` keeping everything, a drifted restore failing late) are
held against the port, and ``RestartableLoop`` resumed after an injected
failure must give exactly the factors of an uninterrupted ALS run (the
plain CPU versions are deterministic)."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.core.completion import gauss_newton as jggn
from repro.core.completion import gcp as jgcp
from repro.launch import complete as jcomplete

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.core.completion import als  # noqa: E402
from repro_torch.core.completion import gauss_newton as ggn  # noqa: E402
from repro_torch.core.completion import gcp  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import CompletionDataset  # noqa: E402
from repro_torch.launch import complete  # noqa: E402
from repro_torch.runtime import RestartableLoop  # noqa: E402


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((5, 3), (4, 3), (6, 3), (7,))]


def _structures(a, b, c, rho, lib):
    """The same states built from ``lib``'s arrays and named tuples: a
    tuple of factors, a factor dict, ((factors), rho), GGNState, AdamState
    and a mixed nest (unsorted dict keys, a None, a list in a tuple)."""
    mod = {"jax": (jggn, jgcp), "torch": (ggn, gcp)}[lib]
    f = (jnp.asarray if lib == "jax" else torch.from_numpy)
    a, b, c, rho = f(a), f(b), f(c), f(rho)
    cnt = (jnp.asarray(3, jnp.int32) if lib == "jax"
           else torch.tensor(3, dtype=torch.int32))
    return {
        "factors": (a, b, c),
        "factor_dict": {"factor_0": a, "factor_1": b},
        "ccd": ((a, b, c), rho),
        "ggn": mod[0].GGNState((a, b, c), rho[0]),
        "adam": mod[1].AdamState([a, b], [b, c], cnt),
        "mixed": {"z": [a, (b, None)], "a b": {"y": c, "x": rho}},
    }


NAMES = ["factors", "factor_dict", "ccd", "ggn", "adam", "mixed"]


def test_leaf_keys_equal_reference():
    arrs = _arrays()
    js, ps = _structures(*arrs, "jax"), _structures(*arrs, "torch")
    for name in NAMES:
        assert list(ckpt._leaf_paths(ps[name])) == \
            list(jckpt._leaf_paths(js[name])), name
    assert list(ckpt._leaf_paths(ps["factors"])) == ["_0_", "_1_", "_2_"]
    assert list(ckpt._leaf_paths(ps["factor_dict"])) == ["__factor_0__",
                                                         "__factor_1__"]
    assert list(ckpt._leaf_paths(ps["ccd"])) == [
        "_0___0_", "_0___1_", "_0___2_", "_1_"]


def _zeros_like(tree, lib):
    return (ckpt.tree_map(torch.zeros_like, tree) if lib == "torch" else
            __import__("jax").tree.map(jnp.zeros_like, tree))


def _equal_leaves(got, want):
    g, w = ckpt.tree_leaves(got), ckpt.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_cross_both_ways(name, tmp_path):
    arrs = _arrays(1)
    js, ps = _structures(*arrs, "jax")[name], _structures(*arrs,
                                                           "torch")[name]
    # reference saves, port restores
    jckpt.save(str(tmp_path / "j"), 4, js, metadata={"from": "jax"})
    got, man = ckpt.restore(str(tmp_path / "j"), 4, _zeros_like(ps, "torch"))
    assert man["metadata"] == {"from": "jax"}
    assert type(got) is type(ps)
    _equal_leaves(got, ps)
    assert all(isinstance(x, torch.Tensor) for x in ckpt.tree_leaves(got))
    # port saves, reference restores
    ckpt.save(str(tmp_path / "p"), 4, ps, metadata={"from": "torch"})
    assert jckpt.read_manifest(str(tmp_path / "p"), 4) == \
        {**jckpt.read_manifest(str(tmp_path / "j"), 4),
         "metadata": {"from": "torch"}}
    back, _ = jckpt.restore(str(tmp_path / "p"), 4, _zeros_like(js, "jax"))
    _equal_leaves(back, js)


CLI = ["--dims", "30,20,10", "--nnz", "2000", "--rank", "4", "--sweeps", "2",
       "--cg-iters", "5"]


def test_dump_factors_dir_crosses_both_ways(tmp_path, monkeypatch):
    """``--dump-factors DIR`` of either CLI restores in the other package,
    with the same metadata keys."""
    jdir, pdir = str(tmp_path / "jdump"), str(tmp_path / "pdump")
    monkeypatch.setattr(sys, "argv", ["complete"] + CLI + [
        "--ckpt-dir", str(tmp_path / "jck"), "--dump-factors", jdir])
    jcomplete.main()
    run = complete.main(CLI + ["--device", "cpu", "--dump-factors", pdir])
    jman = jckpt.read_manifest(jdir, 2)
    pman = ckpt.read_manifest(pdir, 2)
    assert set(pman["metadata"]) == set(jman["metadata"])
    assert pman["leaves"] == jman["leaves"]
    for key in ("kind", "rank", "shape", "algorithm", "loss", "link",
                "dataset", "sweeps"):
        assert pman["metadata"][key] == jman["metadata"][key], key
    assert pman["metadata"]["nnz"] == run.dataset.tensor.nnz
    like = {f"factor_{d}": torch.zeros(s, 4) for d, s in
            enumerate((30, 20, 10))}
    jwant, _ = jckpt.restore(jdir, 2, {k: jnp.zeros(v.shape)
                                       for k, v in like.items()})
    got, _ = ckpt.restore(jdir, 2, like)
    _equal_leaves(got, jwant)
    back, _ = jckpt.restore(pdir, 2, {k: jnp.zeros(v.shape)
                                      for k, v in like.items()})
    _equal_leaves(back, {f"factor_{d}": f for d, f in
                         enumerate(run.factors)})


def test_async_error_surfaces_at_wait(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "save", boom)
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save_async(5, {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="step 5") as ei:
        ck.wait()
    assert isinstance(ei.value.__cause__, OSError)
    ck.wait()                       # the error is not sticky


def test_async_save_snapshots_state_and_metadata(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path))
    w = torch.ones(3)
    meta = {"metrics": [1]}
    ck.save_async(2, {"w": w}, meta)
    w.add_(1)
    meta["metrics"].append(2)
    ck.wait()
    got, man = ckpt.restore(str(tmp_path), 2, {"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.ones(3))
    assert man["metadata"] == {"metrics": [1]}


def test_keep_last_zero_keeps_nothing(tmp_path):
    for s in range(3):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep_last=0)
    assert ckpt.latest_step(str(tmp_path)) is None
    assert not [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    for s in range(4):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep_last=1)
    assert os.listdir(tmp_path) == ["step_000000003"]


@pytest.mark.parametrize("drift", ["shape", "dtype", "missing", "corrupt"])
def test_drifted_restore_names_the_leaf(drift, tmp_path):
    ckpt.save(str(tmp_path), 1, {"factor_0": torch.ones(6, 4)})
    like = {"factor_0": torch.zeros(6, 4)}
    match = "factor_0"
    if drift == "shape":
        like = {"factor_0": torch.zeros(6, 3)}
        match = r"factor_0.*\(6, 3\)"
    elif drift == "dtype":
        like = {"factor_0": torch.zeros(6, 4, dtype=torch.int32)}
        match = "factor_0.*dtype"
    elif drift == "missing":
        like = {**like, "factor_1": torch.zeros(2)}
        match = "__factor_1__"
    else:
        np.save(os.path.join(tmp_path, "step_000000001",
                             "__factor_0__.npy"), np.ones((2, 4), np.float32))
        match = "factor_0.*corrupted"
    with pytest.raises(ValueError, match=match):
        ckpt.restore(str(tmp_path), 1, like)


def _loop_counter(directory, **kw):
    return RestartableLoop(directory, lambda i, s: s + (i + 1), **kw)


def test_crash_tmp_is_ignored(tmp_path):
    ckpt.save(str(tmp_path), 3, torch.full((2,), 6.0))
    # a save of step 7 that crashed before its rename
    tmp = tmp_path / "step_000000007.tmp"
    tmp.mkdir()
    (tmp / "manifest.json").write_text(json.dumps({"step": 7}))
    assert ckpt.latest_step(str(tmp_path)) == 3
    loop = _loop_counter(str(tmp_path), ckpt_every=100)
    state = loop.run(torch.zeros(2), 6)
    assert torch.equal(state, torch.full((2,), 17.0))   # 6 + 5 + 6: steps 4, 5
    # a later save of step 7 replaces the stale .tmp
    ckpt.save(str(tmp_path), 7, torch.zeros(2))
    assert not tmp.exists() and ckpt.latest_step(str(tmp_path)) == 7


def test_corrupt_newest_step_falls_back(tmp_path):
    loop = _loop_counter(str(tmp_path), ckpt_every=2, keep_last=5)
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        loop.run(torch.zeros(1), 10, fail_at=7)
    newest = max(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert newest == "step_000000007"
    for f in os.listdir(tmp_path / newest):
        if f.endswith(".npy"):
            os.remove(tmp_path / newest / f)
    loop2 = _loop_counter(str(tmp_path), ckpt_every=2, keep_last=5)
    state = loop2.run(torch.zeros(1), 10)
    assert float(state[0]) == 55.0          # 1 + 2 + … + 10
    assert loop2.watchdog.times and len(loop2.watchdog.times) == 4  # 6..9


def test_restartable_als_resume_equals_uninterrupted(tmp_path):
    gen = torch.Generator().manual_seed(0)
    raw = synthetic.function_tensor((30, 20, 10), 2500, gen)
    ds = CompletionDataset(raw, gen)
    factors = [torch.randn(d, 4, generator=gen) / 2 for d in (30, 20, 10)]

    def step(i, fs):
        return tuple(als.als_sweep(ds.tensor, ds.omega, list(fs), 1e-5,
                                   cg_iters=8))

    whole = RestartableLoop(str(tmp_path / "a"), step, ckpt_every=2).run(
        tuple(factors), 6)
    loop = RestartableLoop(str(tmp_path / "b"), step, ckpt_every=2,
                           metadata_fn=lambda s: {"step": s})
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        loop.run(tuple(factors), 6, fail_at=3)
    ran = []
    resumed = RestartableLoop(str(tmp_path / "b"),
                              lambda i, fs: ran.append(i) or step(i, fs),
                              ckpt_every=2, metadata_fn=lambda s: {"step": s})
    got = resumed.run(tuple(factors), 6)
    assert ran == [4, 5]
    assert resumed.last_metadata == {"step": 3}
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    # the same factors restore in the JAX package
    back, _ = jckpt.restore(str(tmp_path / "b"), 5,
                            tuple(jnp.zeros(f.shape) for f in factors))
    _equal_leaves(back, got)
    # nothing left to run: no step, no final save over the stored metadata
    done = RestartableLoop(str(tmp_path / "b"), step, ckpt_every=2)
    again = done.run(tuple(factors), 6)
    assert done.last_metadata == {"step": 5}
    for g, w in zip(again, got):
        assert torch.equal(g, w)


def test_restore_lands_on_like_device(tmp_path):
    factors = interop.factors_from_numpy(_arrays()[:3], "cpu")
    ckpt.save(str(tmp_path), 0, ggn.ggn_init(factors, damping=0.25))
    got, _ = ckpt.restore(str(tmp_path), 0, ggn.ggn_init(
        [torch.zeros_like(f) for f in factors], damping=1.0))
    assert isinstance(got, ggn.GGNState)
    assert float(got.damping) == 0.25
    assert all(f.device.type == "cpu" for f in got.factors)
