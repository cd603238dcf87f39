"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports no jax, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol = atol = 1e-4: shared-memory atomics change the order of the
bucket sums from run to run."""
import os
import sys

import numpy as np
import pytest
import torch

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop
from repro_torch.core.completion import als
from repro_torch.kernels import cg_matvec as kcg
from repro_torch.kernels import mttkrp as kmttkrp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tttp as ktttp

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _problem(device, seed, shape, nnz, r, sort_mode=None):
    """Padded COO whose mode-0 rows fill only the lower half (empty upper
    buckets), in random order or sorted by ``sort_mode``, and factors;
    numpy-made so CPU and card see the same data."""
    rng = np.random.default_rng(seed)
    hi = [s // 2 if d == 0 else s for d, s in enumerate(shape)]
    idx = np.zeros((nnz + 19, len(shape)), np.int32)
    idx[:nnz] = np.stack([rng.integers(0, h, nnz) for h in hi], 1)
    vals = np.zeros(nnz + 19, np.float32)
    vals[:nnz] = rng.uniform(0, 1, nnz)
    valid = np.arange(nnz + 19) < nnz
    perm = rng.permutation(nnz + 19)
    factors = [(0.5 * rng.standard_normal((s, r))).astype(np.float32)
               for s in shape]
    st = interop.sparse_from_numpy(idx[perm], vals[perm], valid[perm], shape,
                                   device)
    if sort_mode is not None:
        st = st.sort_by_mode(sort_mode)
    return st, interop.factors_from_numpy(factors, device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((40, 24, 12), 10), ((40, 24, 12), 64),
                                     ((26, 10, 8, 6), 10)])
@pytest.mark.parametrize("block_rows", [8, 16])
def test_kernels_match_plain_versions(dev, shape, r, block_rows):
    st, fs = _problem(dev, 0, shape, 3000, r)
    vals = st.values * st.mask
    torch.testing.assert_close(kops.tttp_values(st, fs),
                               kref.tttp_ref(vals, st.indices, fs), **TOL)
    for mode in range(len(shape)):
        bk = st.row_buckets(mode, block_rows)
        others = list(fs)
        others[mode] = None
        torch.testing.assert_close(
            kops.mttkrp_bucketed(bk, others),
            kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                     others, mode,
                                     block_rows)[:shape[mode]], **TOL)
        torch.testing.assert_close(
            kops.cg_matvec_bucketed(bk, fs, fs[mode]),
            kref.cg_matvec_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                        fs, fs[mode], mode,
                                        block_rows)[:shape[mode]], **TOL)


# (shape, nnz, R, sort_mode): R = 3 and 10 pad to a 16-byte row stride;
# (400, 30, 20) has about 12 slots per bucket of 8 rows, so a warp's slots
# cross several rows and the flush takes its per-lane path; in the others a
# thread's run of slots crosses rows, so its running sum flushes inside the
# capacity loop ((24, 30, 20): thousands of slots per bucket); the sorted
# tensor's buckets over mode 0 gather through a monotone sel, the others
# through a shuffled one
EDGE_CASES = [((40, 24, 12), 3000, 3, None), ((400, 30, 20), 600, 10, None),
              ((24, 30, 20), 12000, 10, None), ((60, 30, 20), 6000, 10, 0),
              ((26, 10, 8, 6), 3000, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nnz,r,sort_mode", EDGE_CASES)
@pytest.mark.parametrize("block_rows", [8, 16])
def test_bucketed_kernels_on_layout_edge_cases(dev, shape, nnz, r, sort_mode,
                                               block_rows):
    from repro_torch.kernels import _build
    st, fs = _problem(dev, 3, shape, nnz, r, sort_mode)
    for mode in (0, len(shape) - 1):
        bk = st.row_buckets(mode, block_rows)
        others = list(fs)
        others[mode] = None
        got = kops.mttkrp_bucketed(bk, others)
        want = kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                        others, mode,
                                        block_rows)[:shape[mode]]
        torch.testing.assert_close(got, want, **TOL)
        x = 0.5 * torch.randn(shape[mode], r, device=dev)
        got = kops.cg_matvec_bucketed(bk, fs, x)
        want = kref.cg_matvec_bucketed_ref(bk.values, bk.indices,
                                           bk.local_row, fs, x, mode,
                                           block_rows)[:shape[mode]]
        torch.testing.assert_close(got, want, **TOL)
    bk = st.row_buckets(0, block_rows)
    assert bool((bk.valid.sum(1) == 0).any())        # an empty bucket
    assert bk.capacity % _build.THREADS != 0         # a ragged last step
    if bk.capacity >= 2 * _build.THREADS:
        # some thread's slots (c ≡ t mod THREADS) span more than one row
        lr = bk.local_row[:, :bk.capacity // _build.THREADS * _build.THREADS]
        runs = lr.reshape(bk.num_blocks, -1, _build.THREADS)
        assert bool((runs.amax(1) != runs.amin(1)).any())


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_bad_operands(dev):
    st, fs = _problem(dev, 1, (30, 20, 10), 800, 10)
    kops.reset_launch_counts()
    kops.tttp_values(st, fs)
    bk = st.row_buckets(0, 8)
    kops.mttkrp_bucketed(bk, [None] + fs[1:])
    kops.cg_matvec_bucketed(bk, fs, fs[0])
    assert kops.launch_counts() == {"tttp": 1, "mttkrp": 1, "cg_matvec": 1}
    vals = st.values * st.mask
    with pytest.raises(TypeError):
        ktttp.tttp_cuda(vals.double(), st.indices, fs)
    with pytest.raises(ValueError, match="contiguous"):
        ktttp.tttp_cuda(vals, st.indices, [f.t().contiguous().t()
                                           for f in fs])
    with pytest.raises(ValueError, match="CUDA device"):
        ktttp.tttp_cuda(vals, st.indices, [fs[0].cpu()] + fs[1:])
    wide = [torch.zeros(f.shape[0], 129, device=dev) for f in fs]
    with pytest.raises(ValueError, match="R=129"):
        kcg.cg_matvec_cuda(bk, wide, wide[0])
    with pytest.raises(ValueError, match="R=129"):
        kmttkrp.mttkrp_cuda(bk, [None] + wide[1:])
    assert kops.launch_counts() == {"tttp": 1, "mttkrp": 1, "cg_matvec": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "tttp_mttkrp"])
def test_als_sweep_on_card_matches_plain_path(dev, path):
    st, fs = _problem(dev, 2, (40, 30, 20), 4000, 6)
    omega = st.with_values(torch.ones_like(st.values))
    got = als.als_sweep(st, omega, fs, 1e-5, cg_iters=12, matvec_path=path)
    cpu = interop.sparse_from_numpy(st.indices.cpu().numpy(),
                                    st.values.cpu().numpy(),
                                    st.valid.cpu().numpy(), st.shape, "cpu")
    want = als.als_sweep(cpu, cpu.with_values(torch.ones_like(cpu.values)),
                         [f.cpu() for f in fs], 1e-5, cg_iters=12,
                         matvec_path=path)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)
