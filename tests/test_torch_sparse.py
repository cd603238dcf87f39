"""Parity of the PyTorch port's sparse container, CCSR bucket patterns, data
generation and ingest with the JAX package, on shared numpy inputs.

Bucket patterns must be bit-identical: the port's CUDA kernels consume
exactly this layout. The port never imports jax (checked in a subprocess
with jax blocked)."""
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.data import synthetic as jsynthetic
from repro.sparse import ccsr as jccsr

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

import repro_torch
from repro_torch import interop
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import synthetic
from repro_torch.data.pipeline import CompletionDataset
from repro_torch.sparse import ccsr


def _coo(seed, shape, nnz, half_mode0=False):
    """Random COO with duplicates possible; optionally mode-0 rows only in
    the lower half so the upper buckets are empty."""
    rng = np.random.default_rng(seed)
    hi = [s // 2 if (half_mode0 and d == 0) else s
          for d, s in enumerate(shape)]
    idx = np.stack([rng.integers(0, h, nnz) for h in hi], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return idx, vals


def _both(idx, vals, shape, cap):
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), shape,
                               cap=cap)
    t = SparseTensor.from_coo(idx, vals, shape, cap=cap, device="cpu")
    return j, t


def _shuffled_both(seed, shape, nnz, cap):
    """Both packages' tensors on the same shuffled, padded entries."""
    idx, vals = _coo(seed, shape, nnz, half_mode0=True)
    j, _ = _both(idx, vals, shape, cap)
    perm = np.random.default_rng(seed + 1).permutation(cap)
    j = JSparseTensor(j.indices[perm], j.values[perm], j.valid[perm], shape,
                      nnz)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values),
                                  np.asarray(j.valid), shape, "cpu")
    return j, t


def test_from_coo_and_todense_match():
    idx, vals = _coo(0, (9, 7, 5), 60)
    j, t = _both(idx, vals, (9, 7, 5), cap=71)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert (t.cap, t.ndim, t.nnz, t.shape) == (j.cap, j.ndim, j.nnz, j.shape)
    np.testing.assert_allclose(t.todense().numpy(), np.asarray(j.todense()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t.masked_values().numpy(),
                                  np.asarray(j.masked_values()))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_sort_by_mode_bit_identical(mode):
    j, t = _shuffled_both(1, (11, 8, 6), 80, cap=96)
    js, ts = j.sort_by_mode(mode), t.sort_by_mode(mode)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ts.sorted_mode == js.sorted_mode == mode


PATTERN_CASES = [((37, 20, 12), 300, 8), ((17, 12, 9, 7), 250, 4)]


@pytest.mark.parametrize("shape,nnz,block_rows", PATTERN_CASES)
@pytest.mark.parametrize("presorted", [False, True])
def test_bucket_pattern_bit_identical(shape, nnz, block_rows, presorted):
    j, t = _shuffled_both(2, shape, nnz, cap=nnz + 29)
    for mode in range(len(shape)):
        jj, tt = ((j.sort_by_mode(mode), t.sort_by_mode(mode)) if presorted
                  else (j, t))
        jp = jccsr.bucket_pattern(jj, mode, block_rows)
        tp = ccsr.bucket_pattern(tt, mode, block_rows)
        for field in ("sel", "indices", "local_row", "valid"):
            got, want = getattr(tp, field).numpy(), np.asarray(getattr(jp, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        assert (tp.mode, tp.block_rows, tp.shape, tp.cap) == \
            (jp.mode, jp.block_rows, jp.shape, jp.cap)
        jb, tb = jp.gather(jj), tp.gather(tt)
        np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
        assert (tb.num_blocks, tb.capacity) == (jb.num_blocks, jb.capacity)
        if mode == 0:
            assert (tb.valid.sum(1) == 0).any(), "want empty buckets"


def test_bucket_capacity_and_overflow():
    counts = np.array([3, 0, 17, 9])
    assert ccsr.bucket_capacity(counts) == jccsr.bucket_capacity(counts) == 24
    assert ccsr.bucket_capacity(np.zeros(0, np.int64)) == \
        jccsr.bucket_capacity(np.zeros(0, np.int64))
    idx, vals = _coo(3, (16, 8, 4), 100)
    t = SparseTensor.from_coo(idx, vals, (16, 8, 4), device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        ccsr.bucket_pattern(t, 0, block_rows=4, capacity=2)
    with pytest.raises(ValueError):
        ccsr.bucket_pattern(t, 0, 4).gather(
            SparseTensor.from_coo(idx, vals, (16, 8, 4), cap=120))


def test_with_values_shares_pattern_cache():
    idx, vals = _coo(4, (20, 10, 6), 150)
    t = SparseTensor.from_coo(idx, vals, (20, 10, 6), cap=160)
    bk = t.row_buckets(1, 8)
    omega = t.with_values(torch.ones_like(t.values))
    assert omega._pattern_cache is t._pattern_cache
    ob = omega.row_buckets(1, 8)
    assert torch.equal(ob.indices, bk.indices)
    np.testing.assert_array_equal(ob.values.numpy(), bk.valid.numpy()
                                  .astype(np.float32))


def test_row_buckets_gathers_once_per_tensor():
    """The gathered bucket values are kept per tensor: a second call hands
    back the same tensors, a with_values derivation gathers its own, and an
    in-place write to the values brings a fresh gather."""
    idx, vals = _coo(8, (20, 10, 6), 150)
    t = SparseTensor.from_coo(idx, vals, (20, 10, 6), cap=160)
    bk = t.row_buckets(0, 8)
    again = t.row_buckets(0, 8)
    assert again is bk and again.values is bk.values
    assert t.row_buckets(1, 8).values is not bk.values
    omega = t.with_values(torch.ones_like(t.values))
    ob = omega.row_buckets(0, 8)
    assert ob.values is not bk.values and ob.indices is bk.indices
    np.testing.assert_array_equal(ob.values.numpy(),
                                  bk.valid.numpy().astype(np.float32))
    assert t.row_buckets(0, 8).values is bk.values
    t.values.mul_(3)
    fresh = t.row_buckets(0, 8)
    assert fresh.values is not bk.values
    np.testing.assert_array_equal(fresh.values.numpy(),
                                  3 * bk.values.numpy())
    assert t.row_buckets(0, 8) is fresh
    t.valid[:] = False
    assert not t.row_buckets(0, 8).values.any()


def test_function_tensor_matches_reference_statistics():
    """Different random streams: compare the distribution only."""
    shape, nnz = (300, 200, 100), 20_000
    t = synthetic.function_tensor(shape, nnz,
                                  torch.Generator().manual_seed(0))
    j = jsynthetic.function_tensor(jax.random.PRNGKey(0), shape, nnz)
    tv, jv = t.values.numpy(), np.asarray(j.values)
    assert t.indices.dtype == torch.int32 and t.nnz == nnz
    for d, s in enumerate(shape):
        col = t.indices[:, d]
        assert int(col.min()) >= 0 and int(col.max()) < s
        assert abs(float(col.float().mean()) - (s - 1) / 2) < 0.02 * s
    assert 0.0 < tv.min() and tv.max() < 1.0
    # the mean moves with the random grid draws; both sit near the
    # symmetric value 0.5 and spread alike
    assert abs(tv.mean() - 0.5) < 0.15 and abs(jv.mean() - 0.5) < 0.15
    assert abs(tv.std() - jv.std()) < 0.05


def test_shuffle_and_pad_is_a_permutation():
    idx, vals = _coo(5, (12, 9, 5), 70)
    t = SparseTensor.from_coo(idx, vals, (12, 9, 5), cap=75)
    s = synthetic.shuffle_and_pad(t, torch.Generator().manual_seed(1), 4)
    assert s.cap == 76 and int(s.valid.sum()) == 70 and s.nnz == 70
    def entries(x):
        keep = x.valid.numpy()
        return sorted(map(tuple, np.c_[x.indices.numpy()[keep],
                                       x.values.numpy()[keep]].tolist()))
    assert entries(s) == entries(t)


def test_completion_dataset_builds_shared_patterns():
    t = synthetic.function_tensor((40, 30, 20), 2000,
                                  torch.Generator().manual_seed(2))
    ds = CompletionDataset(t, torch.Generator().manual_seed(3), block_rows=8)
    assert ds.omega._pattern_cache is ds.tensor._pattern_cache
    assert set(ds.tensor._pattern_cache) == {(0, 8), (1, 8), (2, 8)}
    assert torch.equal(ds.omega.values, ds.tensor.valid.float())


def test_interop_factors_round_trip():
    arrays = [np.arange(6, dtype=np.float64).reshape(3, 2)]
    (f,) = interop.factors_from_numpy(arrays, "cpu")
    assert f.dtype == torch.float32 and f.is_contiguous()
    np.testing.assert_array_equal(f.numpy(), arrays[0])


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_without_jax_or_repro():
    """Every repro_torch module imports with jax and repro blocked."""
    mods = _port_modules()
    assert "repro_torch.launch.complete" in mods and len(mods) >= 20
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(PORT))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# the rest of the sparse format, bit for bit against the reference
# ---------------------------------------------------------------------------

from repro.core import utils as jutils  # noqa: E402
from repro_torch.core import utils  # noqa: E402
from repro_torch.sparse import ops as sops  # noqa: E402

FMT_SHAPE = (13, 9, 7)


def _dyadic_both(seed, dense=None, nnz=90, cap=104):
    """Both packages' tensors on the same shuffled, padded entries (mode-0
    rows in the lower half, duplicates possible). The values are multiples
    of 1/8 in [-4, 4), so every sum of them, and of their squares, is exact
    in float32: a reduction in any order gives the same bits."""
    idx, _ = _coo(seed, FMT_SHAPE, nnz, half_mode0=True)
    rng = np.random.default_rng(seed + 7)
    vshape = (nnz,) if dense is None else (nnz, dense)
    vals = (rng.integers(-32, 32, vshape) / 8).astype(np.float32)
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), FMT_SHAPE,
                               cap=cap)
    perm = np.random.default_rng(seed + 1).permutation(cap)
    j = JSparseTensor(j.indices[perm], j.values[perm], j.valid[perm],
                      FMT_SHAPE, nnz)
    t = SparseTensor(*(torch.from_numpy(np.array(a)) for a in
                       (j.indices, j.values, j.valid)), FMT_SHAPE, nnz)
    return j, t


def _fields(x):
    """The arrays of a result, in order, as numpy."""
    if isinstance(x, (SparseTensor, JSparseTensor)):
        return [x.indices, x.values, x.valid]
    if isinstance(x, (ccsr.CCSRView, jccsr.CCSRView)):
        return [x.row_ids, x.row_ptr, x.nnz_rows]
    if isinstance(x, (ccsr.RowBlockBuckets, jccsr.RowBlockBuckets)):
        return [x.values, x.indices, x.local_row, x.valid]
    return [x]


def _case_transpose(j, t):
    return t.transpose((2, 0, 1)), j.transpose((2, 0, 1))


def _case_reshape(j, t):
    return t.reshape((9, 13, 7)), j.reshape((9, 13, 7))


def _case_reshape_flat(j, t):
    return t.reshape((13 * 9 * 7,)), j.reshape((13 * 9 * 7,))


def _case_linearize(j, t):
    return (utils.linearize(t.indices, FMT_SHAPE),
            jutils.linearize(j.indices, FMT_SHAPE))


def _case_delinearize(j, t):
    lin = np.arange(0, 13 * 9 * 7, 5)
    return (utils.delinearize(torch.from_numpy(lin), FMT_SHAPE),
            jutils.delinearize(jnp.asarray(lin), FMT_SHAPE))


def _case_lex_sort_perm(j, t):
    return (utils.lex_sort_perm(t.indices, t.valid, (2, 0, 1)),
            jutils.lex_sort_perm(j.indices, j.valid, (2, 0, 1)))


def _case_rows_equal(j, t):
    other = t.indices.flip(0)
    return (utils.rows_equal(t.indices, other),
            jutils.rows_equal(j.indices, jnp.asarray(other.numpy())))


FMT_CASES = {
    "dense_dim": lambda j, t: (t.dense_dim, j.dense_dim),
    "count_valid": lambda j, t: (t.count_valid(), j.count_valid()),
    "astype": lambda j, t: (t.astype(torch.float64),
                            j.astype(jnp.float32)),
    "transpose": _case_transpose,
    "reshape": _case_reshape,
    "reshape_flat": _case_reshape_flat,
    "scale": lambda j, t: (t.scale(0.5), j.scale(0.5)),
    "add": lambda j, t: (t.add(t.scale(2.0)), j.add(j.scale(2.0))),
    "reduce_mode": lambda j, t: (t.reduce_mode(1), j.reduce_mode(1)),
    "reduce_mode_cut": lambda j, t: (t.reduce_mode(0, 4),
                                     j.reduce_mode(0, 4)),
    "sum": lambda j, t: (t.sum(), j.sum()),
    "norm": lambda j, t: (t.norm(), j.norm()),
    "linearize": _case_linearize,
    "delinearize": _case_delinearize,
    "lex_sort_perm": _case_lex_sort_perm,
    "rows_equal": _case_rows_equal,
    "global_norm": lambda j, t: (
        utils.global_norm({"v": t.values, "s": [t.values[:5], None]}),
        jutils.global_norm({"v": j.values, "s": [j.values[:5], None]})),
    "param_count": lambda j, t: (
        utils.param_count({"v": t.values, "s": (t.indices,)}),
        jutils.param_count({"v": j.values, "s": (j.indices,)})),
    "bucketize": lambda j, t: (ccsr.bucketize(t, 1, 4),
                               jccsr.bucketize(j, 1, 4)),
    "build_ccsr": lambda j, t: (ccsr.build_ccsr(t.sort_by_mode(0), 0),
                                jccsr.build_ccsr(j.sort_by_mode(0), 0)),
    "build_ccsr_rows_cap": lambda j, t: (
        ccsr.build_ccsr(t.sort_by_mode(2), 2, rows_cap=4),
        jccsr.build_ccsr(j.sort_by_mode(2), 2, rows_cap=4)),
    "from_coo_pad_multiple": lambda j, t: (
        SparseTensor.from_coo(t.indices[:50], t.values[:50], FMT_SHAPE,
                              pad_multiple=16),
        JSparseTensor.from_coo(j.indices[:50], j.values[:50], FMT_SHAPE,
                               pad_multiple=16)),
}
# the same functions on values with a trailing dense axis
DENSE_CASES = ("dense_dim", "with_values", "todense", "scale", "add",
               "reduce_mode", "sum", "norm", "transpose")
FMT_CASES["with_values"] = lambda j, t: (t.with_values(t.values * 3),
                                         j.with_values(j.values * 3))
FMT_CASES["todense"] = lambda j, t: (t.todense(), j.todense())


@pytest.mark.parametrize("name,dense", [(n, None) for n in FMT_CASES]
                         + [(n, 3) for n in DENSE_CASES])
def test_sparse_format_bit_identical(name, dense):
    j, t = _dyadic_both(11, dense)
    got, want = FMT_CASES[name](j, t)
    if name == "astype":    # the cast itself, then back to float32
        assert got.values.dtype == torch.float64
        got = got.astype(torch.float32)
    if isinstance(got, SparseTensor):
        assert got.shape == want.shape and got.nnz == want.nnz
        assert got.sorted_mode == want.sorted_mode
        assert got.nnz_rows == want.nnz_rows
    if isinstance(got, ccsr.CCSRView):
        assert (got.num_rows, got.rows_cap) == (want.num_rows, want.rows_cap)
    gf, wf = _fields(got), _fields(want)
    assert len(gf) == len(wf)
    for g, w in zip(gf, wf):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if g.dtype.kind == "f":
            assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_transpose_keeps_nnz_rows_and_reshape_refuses_size():
    j, t = _dyadic_both(12)
    t.nnz_rows = j.nnz_rows = (5, 6, 7)
    assert t.transpose((1, 2, 0)).nnz_rows == j.transpose((1, 2, 0)).nnz_rows
    with pytest.raises(ValueError, match="size mismatch"):
        t.reshape((5, 5))
    with pytest.raises(ValueError, match="shapes"):
        t.add(t.transpose((1, 0, 2)))
    with pytest.raises(ValueError, match="sorted"):
        ccsr.build_ccsr(t, 0)
    with pytest.raises(ValueError, match="dense axis"):
        t.with_values(torch.ones(t.cap, 2)).row_buckets(0, 4)
    with pytest.raises(ValueError, match="overflows int64"):
        utils.linearize(t.indices, (2 ** 40, 2 ** 40))


def test_random_statistics():
    """The reference's random tensor comes from jax.random, which torch
    cannot reproduce: shape, range and distinct-index statistics only."""
    shape, nnz = (50, 40, 30), 6000
    t = SparseTensor.random(torch.Generator().manual_seed(0), shape, nnz,
                            cap=6008)
    j = JSparseTensor.random(jax.random.PRNGKey(0), shape, nnz, cap=6008)
    assert t.cap == j.cap == 6008 and t.nnz == j.nnz == nnz
    assert t.indices.dtype == torch.int32 and t.values.dtype == torch.float32
    assert int(t.count_valid()) == int(j.count_valid()) == nnz
    v = t.values[:nnz].numpy()
    assert -1.0 <= v.min() and v.max() < 1.0 and abs(v.mean()) < 0.05
    assert not t.values[nnz:].any()
    for d, s in enumerate(shape):
        col, jcol = t.indices[:nnz, d].numpy(), np.asarray(j.indices[:nnz, d])
        assert col.min() >= 0 and col.max() < s
        # both draw uniformly: the same share of the rows is hit
        assert abs(len(np.unique(col)) - len(np.unique(jcol))) <= 0.1 * s
    lin = utils.linearize(t.indices[:nnz], shape).numpy()
    jlin = np.asarray(jutils.linearize(j.indices[:nnz], shape))
    # duplicates ~ nnz^2 / (2 cells) = 300 in both
    assert abs(len(np.unique(lin)) - len(np.unique(jlin))) < 60
