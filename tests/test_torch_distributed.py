"""Distribution of the PyTorch port (``core.distributed``,
``core.collectives``, ``sparse.redistribute``, ``optim.compression``,
``runtime.elastic``) against the JAX package's LOCAL results on the same
numpy arrays: the reference's own mesh runs are no oracle on this jax
(they stop at its eager RMSE gather).

The ranks run in a subprocess whose script imports only ``repro_torch``,
torch and numpy: it spawns P gloo ranks on the CPU (``torch.multiprocessing``,
a ``FileStore`` rendezvous), each runs every check of ``tests/test_distributed.py``
and ``tests/test_redistribute.py`` at its grid and writes its results as
an ``.npz``, which this process assembles (rows by data index, columns by
model index) and holds against the reference, naming the check. Grids: 2
ranks (2 x 1, data only), 4 (2 x 2) and 8 (4 x 2); the row-sharded pair,
the butterfly, the compressed psum and the distributed transpose run over
all P ranks as one data axis. rtol = atol = 1e-4 in float32 (the
reference's); GGN in float64 at 1e-8."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core import tttp as jtttp
from repro.core.completion import als as jals
from repro.core.completion import gauss_newton as jggn
from repro.core.distributed import LOCAL as JLOCAL
from repro.core.distributed import mttkrp_ctx as jmttkrp_ctx
from repro.core.distributed import tttp_ctx as jtttp_ctx
from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.planner import ir as jir
from repro.sparse import ops as jsops

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import planner  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.distributed import AxisCtx, DistLayout  # noqa: E402
from repro_torch.core.sparse_tensor import SparseTensor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.planner import ir as pir  # noqa: E402
from repro_torch.runtime import replan_dense, replan_sparse  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAM = 1e-6
CG_ITERS = 12
GGN_ITERS = dict(cg_iters=6, joint_iters=4, precond_iters=3)
GGN_MODE_ITERS = 40
# (grid of the data x model checks); every check of the world axis at P
GRIDS = [(2, 1), (2, 2), (4, 2)]

_RANKS = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    sys.path.insert(0, os.environ["REPRO_PORT"])
    from repro_torch import interop, obs
    from repro_torch.core import collectives as coll
    from repro_torch.core import losses
    from repro_torch.core.completion import als, gauss_newton as ggn
    from repro_torch.core.distributed import (
        DistLayout, mttkrp_ctx, mttkrp_rowsharded, multilinear_rowsharded,
        sparse_allreduce_butterfly, tttp_ctx)
    from repro_torch.optim import compressed_psum
    from repro_torch.sparse import redistribute


    def sparse(z, p, dtype=np.float32):
        return interop.sparse_from_numpy(
            z[p + "idx"], z[p + "vals"].astype(dtype), z[p + "valid"],
            tuple(z[p + "shape"]), "cpu")


    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))


    def solve_iters():
        """The iterations each CG solve since the last call ran (the
        ``cg/iterations`` bumps of the live registry), then a fresh log."""
        reg = obs.get_registry()
        got = [v for n, _, v in reg.counter_log("cg/")
               if n == "cg/iterations"]
        reg.reset()
        return np.array(got, np.int64)


    def checks(z, grid):
        out = {}
        lay = DistLayout(grid, ("data",), "model")
        ctx = lay.ctx
        out["data_index"] = np.int64(lay.data_index)
        out["model_index"] = np.int64(lay.model_index)
        st = lay.shard(sparse(z, "st_"))
        omega = st.with_values(torch.ones_like(st.values))
        fs = [lay.factor_cols(f32(z[f"f{d}"])) for d in range(3)]
        coll.reset_counts()
        out["tttp"] = tttp_ctx(st, fs, ctx).values.numpy()
        out["mttkrp"] = mttkrp_ctx(st, [None, fs[1], fs[2]], 0, ctx).numpy()
        x0 = lay.factor_cols(f32(z["x0"]))
        out["gram"] = als.gram_matvec(omega, fs, 0, x0, LAM, ctx=ctx,
                                      matvec_path="auto").numpy()
        obs.enable()
        solve_iters()
        for d, f in enumerate(als.als_sweep(st, omega, fs, LAM,
                                            cg_iters=CG_ITERS, ctx=ctx)):
            out[f"als{d}"] = f.numpy()
        out["als_iters"] = solve_iters()
        out["collectives"] = np.array([coll.counts()[k] for k in
                                       ("all_reduce", "bytes")])
        st64 = lay.shard(sparse(z, "st_", np.float64))
        g64 = ggn.ggn_init([lay.factor_cols(torch.from_numpy(z[f"f{d}"]))
                            .double() for d in range(3)])
        for it in range(2):
            g64 = ggn.ggn_sweep(st64, g64, losses.LOSSES["poisson_log"], LAM,
                                ctx=ctx, **GGN_ITERS)
            for d, f in enumerate(g64.factors):
                out[f"ggn{it}_{d}"] = f.numpy()
            out[f"ggn{it}_damping"] = g64.damping.numpy()
        # a damped per-mode pass with room to stop inside its budget
        out["ggn_mode"] = ggn.ggn_update_mode(
            st64, list(g64.factors), 0, losses.LOSSES["poisson_log"], LAM,
            1e-3, cg_iters=GGN_MODE_ITERS, ctx=ctx).numpy()
        out["ggn_iters"] = solve_iters()
        obs.disable()

        # the world as one data axis: row-sharded factors (paper Fig. 2)
        world = DistLayout((dist.get_world_size(),), ("data",), None,
                           ("data",))
        wctx = world.ctx
        out["world_rank"] = np.int64(world.rank)
        rs = world.shard(sparse(z, "rs_"))
        rows = [world.slice(f32(z[f"rf{d}"]), ("data", None))
                for d in range(3)]
        for h in (1, 2):
            out[f"rs_tttp{h}"] = multilinear_rowsharded(
                rs, rows, wctx, h_slices=h).numpy()
            out[f"rs_mttkrp{h}"] = mttkrp_rowsharded(
                rs, rows, 0, wctx, h_slices=h).numpy()
        # butterfly sparse all-reduce of per-rank blocks
        b = interop.sparse_from_numpy(
            z["bf_idx"][world.rank], z["bf_vals"][world.rank],
            z["bf_valid"][world.rank], tuple(z["bf_shape"]), "cpu")
        out["butterfly"] = sparse_allreduce_butterfly(b).todense().numpy()
        # error-feedback int8 psum
        got, _ = compressed_psum(f32(z["cg"][world.rank]),
                                 torch.zeros(z["cg"].shape[1]))
        out["compressed"] = got.numpy()
        # distributed transpose (a global re-sort) and reshape
        tr = world.shard(sparse(z, "tr_"))
        t = redistribute.transpose_distributed(tr, (2, 1, 0), ctx=wctx)
        out["tr_idx"], out["tr_vals"], out["tr_valid"] = (
            t.indices.numpy(), t.values.numpy(), t.valid.numpy())
        out["tr_sorted_mode"] = np.int64(t.sorted_mode)
        r = redistribute.reshape_distributed(t, (8 * 12, 16), ctx=wctx)
        out["rh_idx"], out["rh_valid"] = r.indices.numpy(), r.valid.numpy()
        out["rh_sorted_mode"] = np.int64(r.sorted_mode)
        out["replicated"] = redistribute.replicate(
            torch.full((3,), float(world.rank))).numpy()
        return out


    LAM, CG_ITERS = float(os.environ["T_LAM"]), int(os.environ["T_CG"])
    GGN_ITERS = dict(cg_iters=6, joint_iters=4, precond_iters=3)
    GGN_MODE_ITERS = 40


    def rank_main(rank, world, grid, inp, outdir):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(outdir, "store"),
                                         world),
            rank=rank, world_size=world)
        try:
            with np.load(inp) as z:
                out = checks(dict(z), grid)
            np.savez(os.path.join(outdir, f"rank_{rank}.npz"), **out)
            # no rank tears its connections down while another works
            dist.barrier()
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        inp, outdir, grid = sys.argv[1], sys.argv[2], sys.argv[3]
        grid = tuple(int(g) for g in grid.split(","))
        world = int(np.prod(grid))
        mp.start_processes(rank_main, args=(world, grid, inp, outdir),
                           nprocs=world, join=True, start_method="spawn")
        print("RANKS-OK")
''')


def _coo(rng, shape, nnz, cap):
    """Shuffled padded COO of a smooth function sample (values in (0, 1))."""
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1) \
        .astype(np.int32)
    grids = [rng.uniform(-1, 1, s) for s in shape]
    vals = (1 / (1 + np.exp(-3 * sum(g[idx[:, d]]
                                      for d, g in enumerate(grids)))))
    perm = rng.permutation(cap)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((cap - nnz,) + a.shape[1:], a.dtype)])
    return (pad(idx)[perm], pad(vals.astype(np.float32))[perm],
            (np.arange(cap) < nnz)[perm])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    z = {}
    for p, shape, nnz, cap in (("st_", (32, 24, 16), 2000, 2048),
                               ("rs_", (64, 48, 32), 2000, 2048),
                               ("tr_", (16, 12, 8), 500, 512)):
        z[p + "idx"], z[p + "vals"], z[p + "valid"] = _coo(rng, shape, nnz,
                                                           cap)
        z[p + "shape"] = np.array(shape)
    for d, s in enumerate((32, 24, 16)):
        z[f"f{d}"] = rng.standard_normal((s, 8)) / np.sqrt(8)
    z["x0"] = rng.standard_normal((32, 8)).astype(np.float32)
    for d, s in enumerate((64, 48, 32)):
        z[f"rf{d}"] = rng.standard_normal((s, 8)).astype(np.float32)
    blocks = [_coo(rng, (32, 8), 40, 64) for _ in range(8)]
    for k, i in (("bf_idx", 0), ("bf_vals", 1), ("bf_valid", 2)):
        z[k] = np.stack([b[i] for b in blocks])
    z["bf_shape"] = np.array((32, 8))
    z["cg"] = rng.standard_normal((8, 64)).astype(np.float32)
    return z


def _run_ranks(tmp_path, grid, z):
    inp = tmp_path / "inputs.npz"
    np.savez(inp, **z)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, REPRO_PORT=os.path.abspath(PORT),
               T_LAM=repr(LAM), T_CG=str(CG_ITERS))
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(script), str(inp), str(tmp_path),
         ",".join(map(str, grid))], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0 and "RANKS-OK" in out.stdout, \
        out.stdout[-3000:] + "\n---\n" + out.stderr[-6000:]
    world = int(np.prod(grid))
    return [dict(np.load(tmp_path / f"rank_{r}.npz")) for r in range(world)]


def _by_data(ranks, key):
    """A data-sharded leaf, from the model-index-0 ranks in data order."""
    blocks = sorted((int(r["data_index"]), r[key]) for r in ranks
                    if int(r["model_index"]) == 0)
    return np.concatenate([b for _, b in blocks])


def _by_world(ranks, key):
    """A leaf sharded over all ranks as one data axis, in rank order."""
    return np.concatenate([r[key] for r in sorted(
        ranks, key=lambda r: int(r["world_rank"]))])


def _by_model(ranks, key):
    """A column-sliced leaf, from the data-index-0 ranks in model order."""
    blocks = sorted((int(r["model_index"]), r[key]) for r in ranks
                    if int(r["data_index"]) == 0)
    return np.concatenate([b for _, b in blocks], axis=-1)


def _jst(z, p, dtype=jnp.float32):
    return JSparseTensor(jnp.asarray(z[p + "idx"]),
                         jnp.asarray(z[p + "vals"], dtype),
                         jnp.asarray(z[p + "valid"]),
                         tuple(int(s) for s in z[p + "shape"]),
                         int(z[p + "valid"].sum()))


def _reference(z):
    """The JAX package's LOCAL results on the same arrays."""
    want = {}
    st = _jst(z, "st_")
    omega = st.with_values(jnp.ones_like(st.values))
    fs = [jnp.asarray(z[f"f{d}"], jnp.float32) for d in range(3)]
    want["tttp"] = np.asarray(jtttp_ctx(st, fs, JLOCAL).values)
    want["mttkrp"] = np.asarray(jmttkrp_ctx(st, [None, fs[1], fs[2]], 0,
                                            JLOCAL))
    want["gram"] = np.asarray(jals.gram_matvec(
        omega, fs, 0, jnp.asarray(z["x0"]), lam=LAM, matvec_path="auto"))
    sweep = jax.jit(lambda s, o, f: tuple(jals.als_sweep(
        s, o, list(f), LAM, cg_iters=CG_ITERS)))
    for d, f in enumerate(sweep(st, omega, tuple(fs))):
        want[f"als{d}"] = np.asarray(f)
    with jax.enable_x64(True):
        st64 = _jst(z, "st_", jnp.float64)
        state = jggn.ggn_init([jnp.asarray(z[f"f{d}"]) for d in range(3)])
        step = jax.jit(lambda s, g: jggn.ggn_sweep(
            s, g, jlosses.LOSSES["poisson_log"], LAM, **GGN_ITERS))
        for it in range(2):
            state = step(st64, state)
            for d, f in enumerate(state.factors):
                want[f"ggn{it}_{d}"] = np.asarray(f)
            want[f"ggn{it}_damping"] = np.asarray(state.damping)
        want["ggn_mode"] = np.asarray(jggn.ggn_update_mode(
            st64, list(state.factors), 0, jlosses.LOSSES["poisson_log"],
            LAM, 1e-3, cg_iters=GGN_MODE_ITERS))
    rs = _jst(z, "rs_")
    rows = [jnp.asarray(z[f"rf{d}"]) for d in range(3)]
    # the port's multilinear values are 0 on padding slots
    want["rs_tttp"] = np.where(z["rs_valid"], np.asarray(
        jtttp.multilinear_values(rs, rows)), 0)
    want["rs_mttkrp"] = np.asarray(jsops.mttkrp(rs, [None, rows[1], rows[2]],
                                                0))
    return want


_CACHE = {}


def _results(tmp_path_factory, grid):
    if grid not in _CACHE:
        z = _inputs()
        if "ref" not in _CACHE:
            _CACHE["ref"] = _reference(z)
        _CACHE[grid] = (z, _run_ranks(
            tmp_path_factory.mktemp(f"ranks_{grid[0]}x{grid[1]}"), grid, z))
    return _CACHE[grid] + (_CACHE["ref"],)


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_data_model_axes_match_local_reference(tmp_path_factory, grid):
    """TTTP, MTTKRP, the planner's Gram matvec, an ALS sweep (fused under a
    data axis alone, the cost model's choice under a model axis) at 1e-4,
    and two GGN iterations in float64 at 1e-8 (damping exactly), each on
    the rank's shard and column slices, against the reference's LOCAL
    functions on the whole arrays."""
    z, ranks, want = _results(tmp_path_factory, grid)
    np.testing.assert_allclose(_by_data(ranks, "tttp"), want["tttp"],
                               err_msg="tttp", **TOL)
    for key in ("mttkrp", "gram", "als0", "als1", "als2"):
        np.testing.assert_allclose(_by_model(ranks, key), want[key],
                                   err_msg=key, **TOL)
        # every data shard holds the same replicated rows
        for r in ranks:
            if int(r["model_index"]) == 0:
                np.testing.assert_array_equal(r[key], ranks[0][key],
                                              err_msg=key)
    for it in range(2):
        for d in range(3):
            key = f"ggn{it}_{d}"
            np.testing.assert_allclose(_by_model(ranks, key), want[key],
                                       rtol=1e-8, atol=1e-8, err_msg=key)
        for r in ranks:
            assert float(r[f"ggn{it}_damping"]) == \
                float(want[f"ggn{it}_damping"])
    # the collectives were counted: a data axis all-reduces every MTTKRP
    # and every matvec the CG ran (1 + its iterations a mode)
    n_reduce, n_bytes = ranks[0]["collectives"]
    assert n_reduce >= 2 * 3 + int(ranks[0]["als_iters"].sum())
    assert n_bytes > 0


CG_GRIDS = [(2, 1), (1, 2)]


@pytest.mark.parametrize("grid", CG_GRIDS,
                         ids=[f"{a}x{b}" for a, b in CG_GRIDS])
def test_cg_stops_on_the_same_iteration_on_every_rank(tmp_path_factory,
                                                      grid):
    """Under a data axis and under a model axis, every rank's CG stops on
    the same iteration (no rank waits in a matvec's collective the others
    never issue): ALS's three solves and GGN's damped per-mode passes run
    the same iteration counts on every rank, some stopping inside their
    budgets, and the factors match the reference's LOCAL runs."""
    z, ranks, want = _results(tmp_path_factory, grid)
    for key in ("als_iters", "ggn_iters"):
        for r in ranks:
            np.testing.assert_array_equal(r[key], ranks[0][key],
                                          err_msg=key)
    als_iters, ggn_iters = ranks[0]["als_iters"], ranks[0]["ggn_iters"]
    assert len(als_iters) == 3 and (als_iters < CG_ITERS).all()
    assert len(ggn_iters) == 2 * 3 + 1
    assert 0 < ggn_iters[-1] < GGN_MODE_ITERS
    for key in ("als0", "als1", "als2"):
        np.testing.assert_allclose(_by_model(ranks, key), want[key],
                                   err_msg=key, **TOL)
    for key in [f"ggn{it}_{d}" for it in range(2) for d in range(3)] + \
            ["ggn_mode"]:
        np.testing.assert_allclose(_by_model(ranks, key), want[key],
                                   rtol=1e-8, atol=1e-8, err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a * b}" for a, b in GRIDS])
def test_world_axis_collectives_match_local(tmp_path_factory, grid):
    """Over all P ranks as one data axis: the row-sharded multilinear
    values and MTTKRP at h_slices 1 and 2 (reduce-scattered row blocks),
    the butterfly sparse all-reduce (every rank ends with the sum of all
    blocks), the compressed psum (within the reference's 0.1 relative
    bound), the distributed transpose (a global re-sort: valid entries
    first, sorted by the new leading mode, the same tensor) and the
    order-keeping reshape, and a replicate (rank 0's broadcast)."""
    z, ranks, want = _results(tmp_path_factory, grid)
    p = len(ranks)
    for h in (1, 2):
        np.testing.assert_allclose(_by_world(ranks, f"rs_tttp{h}"),
                                   want["rs_tttp"], err_msg=f"rs_tttp{h}",
                                   **TOL)
        np.testing.assert_allclose(_by_world(ranks, f"rs_mttkrp{h}"),
                                   want["rs_mttkrp"],
                                   err_msg=f"rs_mttkrp{h}", **TOL)
    dense = np.zeros(tuple(z["bf_shape"]), np.float64)
    for r in range(p):
        keep = z["bf_valid"][r]
        np.add.at(dense, tuple(z["bf_idx"][r][keep].T), z["bf_vals"][r][keep])
    for r in ranks:
        np.testing.assert_allclose(r["butterfly"], dense, rtol=1e-5,
                                   atol=1e-5, err_msg="butterfly")
    exact = z["cg"][:p].sum(0)
    for r in ranks:
        rel = np.abs(r["compressed"] - exact).max() / np.abs(exact).max()
        assert rel < 0.1, rel
    idx, vals, valid = (_by_world(ranks, k)
                        for k in ("tr_idx", "tr_vals", "tr_valid"))
    nnz = int(valid.sum())
    assert valid[:nnz].all() and not valid[nnz:].any()
    assert (np.diff(idx[:nnz, 0]) >= 0).all()
    assert all(int(r["tr_sorted_mode"]) == 0 for r in ranks)
    got = np.zeros((8, 12, 16))
    np.add.at(got, tuple(idx[valid].T), vals[valid])
    src = np.zeros((16, 12, 8))
    keep = z["tr_valid"]
    np.add.at(src, tuple(z["tr_idx"][keep].T), z["tr_vals"][keep])
    np.testing.assert_allclose(got, np.transpose(src, (2, 1, 0)), rtol=1e-6,
                               atol=1e-6)
    rh, rv = _by_world(ranks, "rh_idx"), _by_world(ranks, "rh_valid")
    assert (np.diff(rh[rv][:, 0]) >= 0).all()
    np.testing.assert_array_equal(rh[rv][:, 0] * 16 + rh[rv][:, 1],
                                  (idx[valid][:, 0] * 12 + idx[valid][:, 1])
                                  * 16 + idx[valid][:, 2])
    assert all(int(r["rh_sorted_mode"]) == 0 for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))


# ---------------------------------------------------------------------------
# in one process: layouts, DistInfo, elastic re-planning, compression
# ---------------------------------------------------------------------------

def _problem(shape=(32, 24, 16), nnz=600, r=8, seed=0):
    rng = np.random.default_rng(seed)
    idx, vals, valid = _coo(rng, shape, nnz, nnz)
    jst = JSparseTensor(jnp.asarray(idx), jnp.asarray(vals),
                        jnp.asarray(valid), shape, nnz)
    tst = SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                       torch.from_numpy(valid), shape, nnz)
    fs = [rng.standard_normal((d, r)).astype(np.float32) for d in shape]
    return jst, tst, [jnp.asarray(f) for f in fs], \
        [torch.from_numpy(f) for f in fs]


def test_candidate_paths_under_model_sharding():
    _, st, _, fs = _problem()
    ops = (st, fs[1], fs[2], fs[0], fs[1], fs[2])
    expr = "abc,bz,cz,ay,by,cy->az"
    assert "fused" in planner.candidate_paths(pir.build_ir(expr, ops))
    cands = planner.candidate_paths(pir.build_ir(
        expr, ops, dist=pir.DistInfo(data_size=4, model_size=2)))
    assert "fused" not in cands and "dense" not in cands
    assert "tttp_mttkrp" in cands


def test_rowsharded_is_the_only_candidate_and_scales_rows():
    jst, st, jfs, fs = _problem()
    local = [f[: f.shape[0] // 4] for f in fs]
    ir = pir.build_ir("abc,bz,cz->az", (st, local[1], local[2]),
                      dist=pir.DistInfo(data_size=4, rowsharded=True))
    assert planner.candidate_paths(ir) == ["rowsharded"]
    assert ir.size_of("b") == st.shape[1]
    jlocal = [f[: f.shape[0] // 4] for f in jfs]
    jir_ = jir.build_ir("abc,bz,cz->az", (jst, jlocal[1], jlocal[2]),
                        dist=jir.DistInfo(data_size=4, rowsharded=True))
    assert ir.sizes == jir_.sizes
    with pytest.raises(ValueError):
        pir.build_ir("abc,bz,cz->az", (st, local[1], local[2]))


def test_comm_terms_rank_distributed_against_local():
    _, st, _, fs = _problem()
    local = pir.build_ir("abc,bz,cz->az", (st, fs[1], fs[2]))
    dist = pir.build_ir("abc,bz,cz->az", (st, fs[1], fs[2]),
                        dist=pir.DistInfo(data_size=4, model_size=1))
    c_local = planner.estimate(local, "all_at_once")
    c_dist = planner.estimate(dist, "all_at_once")
    assert c_local.comm == 0.0 and c_dist.comm > 0.0
    assert c_dist.seconds > c_local.seconds
    # the psum volume is the (rows, R) output, twice (ring all-reduce)
    assert c_dist.comm == pytest.approx(2.0 * st.shape[0] * fs[0].shape[1])


def test_ctx_in_plan_cache_key():
    """LOCAL plans once and hits; a ctx with named axes but no sizes (made
    outside a layout) cannot be planned; ctxs compare by names and sizes,
    not by process groups or coordinates."""
    _, st, _, fs = _problem()
    planner.clear_plan_cache()
    ops = (st, fs[1], fs[2])
    p_local = planner.plan_contraction("abc,bz,cz->az", ops)
    assert p_local.ir.dist is None
    assert planner.plan_contraction("abc,bz,cz->az", ops) is p_local
    with pytest.raises(ValueError, match="no size"):
        planner.plan_contraction("abc,bz,cz->az", ops,
                                 ctx=AxisCtx(data="data"))
    a = AxisCtx("data", "model", (("data", 4), ("model", 2)),
                (("data", 1), ("model", 0)), ("g0", "g1"))
    b = AxisCtx("data", "model", (("data", 4), ("model", 2)),
                (("data", 3), ("model", 1)), ("h0", "h1"))
    assert a == b and hash(a) == hash(b)
    assert (a.data_size(), a.model_size(), a.data_index(),
            b.data_index(), b.model_index()) == (4, 2, 1, 3, 1)
    assert a != AxisCtx("data", "model", (("data", 2), ("model", 2)))


def test_layout_coordinates_slices_and_refusals():
    """Row-major ranks, as ``jax.make_mesh`` lays out devices; several data
    axes flatten in grid order; each rank's shard and column slice; an
    extent that does not divide raises."""
    lays = [DistLayout((2, 2, 2), ("pod", "data"), "model",
                       ("pod", "data", "model"), rank=r) for r in range(8)]
    assert [lay.coords["model"] for lay in lays] == [0, 1] * 4
    assert [lay.data_index for lay in lays] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert lays[5].data_size == 4 and lays[5].model_index == 1
    _, st, _, fs = _problem(nnz=600)
    blocks = [lay.shard(st) for lay in lays[::2]]
    assert all(b.cap == 150 and b.nnz == 600 for b in blocks)
    assert torch.equal(torch.cat([b.values for b in blocks]), st.values)
    cols = [lays[r].factor_cols(fs[0]) for r in (0, 1)]
    assert torch.equal(torch.cat(cols, 1), fs[0])
    with pytest.raises(ValueError, match="multiple"):
        lays[0].factor_cols(fs[0][:, :7])
    with pytest.raises(ValueError, match="multiple"):
        DistLayout((7,), ("data",), None, ("data",), rank=0).shard(st)
    with pytest.raises(ValueError, match="distinct"):
        DistLayout((2, 2), ("data",), "data", rank=0)


def test_elastic_replan_preserves_data():
    """``replan_sparse`` for 1, 2 and 4 shards: the ranks' blocks hold
    every entry once (sum and count), equally sized; ``replan_dense``
    slices each leaf by its spec."""
    _, st, _, fs = _problem(nnz=500)
    total = float(st.sum())
    for shards in (1, 2, 4):
        blocks = [replan_sparse(st, torch.Generator().manual_seed(0),
                                DistLayout((shards,), ("data",), None,
                                           ("data",), rank=r))
                  for r in range(shards)]
        assert len({b.cap for b in blocks}) == 1
        assert abs(sum(float(b.sum()) for b in blocks) - total) < 1e-3
        assert sum(int(b.valid.sum()) for b in blocks) == 500
    assert replan_sparse(st, torch.Generator().manual_seed(0)).cap == st.cap
    tree = {"factors": fs, "count": torch.tensor(3)}
    lay = DistLayout((1, 2), ("data",), "model", rank=1)
    out = replan_dense(tree, lay, lambda path, leaf:
                       (None, "model") if leaf.dim() == 2 else ())
    assert torch.equal(out["factors"][2], fs[2][:, 4:])
    assert int(out["count"]) == 3
    assert replan_dense(tree, None) is tree


def test_shuffle_and_pad_balances_shards():
    _, st, _, _ = _problem(shape=(64, 64, 4), nnz=1000)
    out = synthetic.shuffle_and_pad(st, torch.Generator().manual_seed(1), 8)
    assert out.cap % 8 == 0
    per = out.valid.reshape(8, -1).sum(1).double()
    assert float(per.std()) < float(per.mean()) * 0.2


def _one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    return dist


def test_compression_error_feedback_converges(tmp_path):
    """EF-int8 over a group of one: repeated compression of a constant
    recovers it on average (the reference's check), every call counted as
    two all-reduces (the shared scale, the int32 payload)."""
    from repro_torch.optim import (compressed_psum, compressed_psum_tree,
                                   ef_state_init)
    dist = _one_rank_group(tmp_path)
    try:
        g = torch.full((64,), 1.234e-3)
        err = ef_state_init(g)
        acc = torch.zeros_like(g)
        coll.reset_counts()
        for _ in range(20):
            out, err = compressed_psum(g, err)
            acc = acc + out
        np.testing.assert_allclose((acc / 20).numpy(), g.numpy(), rtol=5e-2)
        assert coll.counts()["all_reduce"] == 40
        tree = {"a": [g, 2 * g], "b": g[:3]}
        outs, errs = compressed_psum_tree(tree, ef_state_init(tree))
        assert set(outs) == {"a", "b"} and len(outs["a"]) == 2
        np.testing.assert_allclose(outs["a"][1].numpy(), 2 * g.numpy(),
                                   rtol=1e-2)
        assert errs["b"].shape == (3,)
    finally:
        dist.destroy_process_group()
