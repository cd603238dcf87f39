"""Parity of the PyTorch port's kernel tier with the JAX package.

On the CPU the port's wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode (``use_pallas=True``), as
tests/test_kernels.py does. Inputs come from a numpy seed and feed both.
Tolerance rtol = atol = 1e-4, the reference's own (tests/test_golden.py),
for sums taken in different orders. The CUDA kernels themselves run only on
a card: tests/test_torch_cuda.py holds them against the plain versions
there."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tttp as jcore_tttp
from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.kernels import ops as jkops
from repro.kernels.tile import scatter_rows as jscatter_rows
from repro.sparse import ccsr as jccsr
from repro.sparse import ops as jsops

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop
from repro_torch.core import tttp as core_tttp
from repro_torch.kernels import cg_matvec as kcg
from repro_torch.kernels import mttkrp as kmttkrp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tile as ktile
from repro_torch.kernels import tttp as ktttp
from repro_torch.sparse import ccsr
from repro_torch.sparse import ops as sops

TOL = dict(rtol=1e-4, atol=1e-4)


def _problem(seed, shape, nnz, r, cap_pad=23, half_mode0=True):
    """Shared padded COO (mode-0 rows only in the lower half, so upper
    buckets are empty) and factors, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    hi = [s // 2 if (half_mode0 and d == 0) else s
          for d, s in enumerate(shape)]
    idx = np.stack([rng.integers(0, h, nnz) for h in hi], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), shape,
                               cap=nnz + cap_pad)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values),
                                  np.asarray(j.valid), shape, "cpu")
    fnp = [(0.7 * rng.standard_normal((s, r))).astype(np.float32)
           for s in shape]
    return (j, [jnp.asarray(f) for f in fnp],
            t, interop.factors_from_numpy(fnp, "cpu"))


def _drop(fs, d):
    fs = list(fs)
    fs[d] = None
    return fs


@pytest.mark.parametrize("schedule", ["onehot", "segmented"])
@pytest.mark.parametrize("block_rows", [8, 16])
def test_scatter_rows_matches_reference(schedule, block_rows):
    rng = np.random.default_rng(block_rows)
    prod = rng.standard_normal((100, 13)).astype(np.float32)
    # sorted keys, padding (key == block_rows) at the tail, some rows empty
    key = np.sort(rng.integers(0, block_rows // 2, 100) * 2).astype(np.int32)
    key[-9:] = block_rows
    got = ktile.scatter_rows(torch.from_numpy(prod), torch.from_numpy(key),
                             block_rows, schedule, torch.float32)
    want = jscatter_rows(jnp.asarray(prod), jnp.asarray(key), block_rows,
                         schedule, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    other = "segmented" if schedule == "onehot" else "onehot"
    np.testing.assert_allclose(
        got.numpy(), ktile.scatter_rows(torch.from_numpy(prod),
                                        torch.from_numpy(key), block_rows,
                                        other, torch.float32).numpy(),
        rtol=1e-5, atol=1e-5)


TTTP_CASES = [((13, 9, 7), 50, 10, None), ((40, 40, 40, 40), 300, 33, None),
              ((30, 20, 10), 200, 10, 1)]


@pytest.mark.parametrize("shape,nnz,r,missing", TTTP_CASES)
def test_tttp_values_matches_pallas(shape, nnz, r, missing):
    j, jf, t, tf = _problem(0, shape, nnz, r, half_mode0=False)
    if missing is not None:
        jf, tf = _drop(jf, missing), _drop(tf, missing)
    want = jkops.tttp_values(j, jf, use_pallas=True, block_m=64, block_r=32)
    got = kops.tttp_values(t, tf)
    assert got.dtype == torch.float32 and got.shape == (t.cap,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multilinear_values_and_tttp_match_reference():
    j, jf, t, tf = _problem(1, (21, 17, 9), 150, 10, half_mode0=False)
    keep = t.valid.numpy()
    np.testing.assert_allclose(
        core_tttp.multilinear_values(t, tf).numpy()[keep],
        np.asarray(jcore_tttp.multilinear_values(j, jf))[keep], **TOL)
    np.testing.assert_allclose(core_tttp.tttp(t, tf).values.numpy(),
                               np.asarray(jcore_tttp.tttp(j, jf).values),
                               **TOL)
    vec = [f[:, 0] for f in tf]
    np.testing.assert_allclose(
        core_tttp.multilinear_values(t, vec).numpy()[keep],
        np.asarray(jcore_tttp.multilinear_values(j, [f[:, 0] for f in jf])
                   )[keep], **TOL)


BUCKET_CASES = [((40, 24, 12), 400, 10, 8, 0), ((40, 24, 12), 400, 10, 8, 2),
                ((26, 10, 8, 6), 300, 16, 16, 0),
                ((26, 10, 8, 6), 300, 16, 4, 3)]


def _buckets(j, t, mode, block_rows):
    jp = jccsr.bucket_pattern(j, mode, block_rows)
    tp = ccsr.bucket_pattern(t, mode, block_rows)
    return jp.gather(j), tp.gather(t)


@pytest.mark.parametrize("shape,nnz,r,block_rows,mode", BUCKET_CASES)
def test_mttkrp_bucketed_matches_pallas(shape, nnz, r, block_rows, mode):
    j, jf, t, tf = _problem(2, shape, nnz, r)
    jb, tb = _buckets(j, t, mode, block_rows)
    jf, tf = _drop(jf, mode), _drop(tf, mode)
    if len(shape) == 4:      # a missing non-target factor is skipped
        gone = 1 if mode != 1 else 2
        jf, tf = _drop(jf, gone), _drop(tf, gone)
    want = jkops.mttkrp_bucketed(jb, jf, use_pallas=True)
    got = kops.mttkrp_bucketed(tb, tf)
    assert got.shape == (shape[mode], r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == 0:
        assert (tb.valid.sum(1) == 0).any()


@pytest.mark.parametrize("shape,nnz,r,block_rows,mode", BUCKET_CASES)
def test_cg_matvec_bucketed_matches_pallas(shape, nnz, r, block_rows, mode):
    j, jf, t, tf = _problem(3, shape, nnz, r)
    jo = j.with_values(jnp.ones_like(j.values))
    to = t.with_values(torch.ones_like(t.values))
    jb, tb = _buckets(jo, to, mode, block_rows)
    x = np.random.default_rng(4).standard_normal((shape[mode], r)) \
        .astype(np.float32)
    want = jkops.cg_matvec_bucketed(jb, jf, jnp.asarray(x), use_pallas=True)
    got = kops.cg_matvec_bucketed(tb, tf, torch.from_numpy(x))
    assert got.shape == (shape[mode], r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_oracles_agree(mode):
    """Bucketed MTTKRP against the all-at-once index_add_ MTTKRP (the port's
    second oracle) and the reference's segment-sum MTTKRP."""
    j, jf, t, tf = _problem(5, (33, 21, 14), 500, 10)
    bk = t.row_buckets(mode, 8)
    got = kops.mttkrp_bucketed(bk, _drop(tf, mode))
    np.testing.assert_allclose(got.numpy(),
                               sops.mttkrp(t, tf, mode).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jsops.mttkrp(j, jf, mode)), **TOL)


def test_cpu_tensors_take_the_plain_path_without_launches():
    j, jf, t, tf = _problem(6, (16, 12, 8), 120, 10)
    kops.reset_launch_counts()
    kops.tttp_values(t, tf)
    bk = t.row_buckets(0, 8)
    kops.mttkrp_bucketed(bk, _drop(tf, 0))
    kops.cg_matvec_bucketed(bk, tf, tf[0])
    assert kops.launch_counts() == {"tttp": 0, "mttkrp": 0, "cg_matvec": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    j, jf, t, tf = _problem(7, (16, 12, 8), 120, 10)
    bk = t.row_buckets(0, 8)
    kops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ktttp.tttp_cuda(t.values, t.indices, tf)
    with pytest.raises(ValueError, match="CUDA"):
        kmttkrp.mttkrp_cuda(bk, _drop(tf, 0))
    with pytest.raises(ValueError, match="CUDA"):
        kcg.cg_matvec_cuda(bk, tf, tf[0])
    assert kops.launch_counts() == {"tttp": 0, "mttkrp": 0, "cg_matvec": 0}


@pytest.mark.parametrize("kernel", ["mttkrp", "cg_matvec"])
def test_bucketed_cuda_wrappers_refuse_rank_over_128(kernel):
    """Both bucketed kernels keep a Khatri-Rao row and a running sum in
    registers for padded widths up to 128 and refuse a wider R before they
    look at the device, so the refusal shows on the CPU too."""
    j, jf, t, tf = _problem(8, (16, 12, 8), 120, 10)
    bk = t.row_buckets(0, 8)
    wide = [torch.zeros(f.shape[0], 129) for f in tf]
    kops.reset_launch_counts()
    with pytest.raises(ValueError, match="R=129"):
        if kernel == "mttkrp":
            kmttkrp.mttkrp_cuda(bk, _drop(wide, 0))
        else:
            kcg.cg_matvec_cuda(bk, wide, wide[0])
    assert kops.launch_counts() == {"tttp": 0, "mttkrp": 0, "cg_matvec": 0}


@pytest.mark.parametrize("schedule", ["onehot", "segmented"])
def test_scatter_rows_batched_buckets_match_reference(schedule):
    """Leading dimensions are independent buckets, as the plain bucketed
    versions (kernels.ref) pass them; each matches the reference's
    one-bucket scatter, and an all-padding bucket sums to zero."""
    rng = np.random.default_rng(11)
    nb, c, r, block_rows = 5, 37, 6, 8
    prod = rng.standard_normal((nb, c, r)).astype(np.float32)
    key = np.sort(rng.integers(0, block_rows, (nb, c)), axis=1)
    key[:, -4:] = block_rows
    key[2] = block_rows
    key = key.astype(np.int32)
    got = ktile.scatter_rows(torch.from_numpy(prod), torch.from_numpy(key),
                             block_rows, schedule, torch.float32)
    assert got.shape == (nb, block_rows, r)
    for b in range(nb):
        want = jscatter_rows(jnp.asarray(prod[b]), jnp.asarray(key[b]),
                             block_rows, schedule, jnp.float32)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert not got[2].any()


@pytest.mark.parametrize("r", [1, 3, 10, 64])
def test_pad_rows_gives_aligned_zero_padded_rows(r):
    """The copies the bucketed kernels gather from: a row stride of a
    multiple of 4 floats (16 bytes) at a 16-byte-aligned address, the
    original rows in front and zeros behind."""
    t = torch.from_numpy(np.random.default_rng(r).standard_normal((37, r))
                         .astype(np.float32))
    p = kmttkrp.pad_rows(t)
    assert p.shape == (37, -(-r // 4) * 4) and p.is_contiguous()
    assert p.stride(0) * 4 % 16 == 0 and p.data_ptr() % 16 == 0
    assert torch.equal(p[:, :r], t)
    assert not p[:, r:].any()
    if r % 4 == 0:
        assert p is t
    # a view off the 16-byte grid is copied even at a width of 4k
    view = torch.zeros(38 * 4 + 1)[1:].view(38, 4)
    assert kmttkrp.pad_rows(view).data_ptr() % 16 == 0


@pytest.mark.parametrize("r", [1, 3, 10, 64])
@pytest.mark.parametrize("mode", [0, 2])
def test_plain_bucketed_versions_exact_on_padded_rows(r, mode):
    """The zero columns the wrappers add add exact zeros: the plain versions
    over padded factors and x, cut back to R columns, equal the unpadded
    results bit for bit."""
    j, jf, t, tf = _problem(12, (40, 24, 12), 600, r)
    bk = t.row_buckets(mode, 8)
    args = (bk.values, bk.indices, bk.local_row)
    pf = [kmttkrp.pad_rows(f) for f in tf]
    assert torch.equal(
        kref.mttkrp_bucketed_ref(*args, _drop(pf, mode), mode, 8)[:, :r],
        kref.mttkrp_bucketed_ref(*args, _drop(tf, mode), mode, 8))
    x = torch.from_numpy(np.random.default_rng(r).standard_normal(
        (t.shape[mode], r)).astype(np.float32))
    assert torch.equal(
        kref.cg_matvec_bucketed_ref(*args, pf, kmttkrp.pad_rows(x), mode,
                                    8)[:, :r],
        kref.cg_matvec_bucketed_ref(*args, tf, x, mode, 8))
