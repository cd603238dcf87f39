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


def _problem(device, seed, shape, nnz, r):
    """Padded COO whose mode-0 rows fill only the lower half (empty upper
    buckets), and factors; numpy-made so CPU and card see the same data."""
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
    return (interop.sparse_from_numpy(idx[perm], vals[perm], valid[perm],
                                      shape, device),
            interop.factors_from_numpy(factors, device))


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
