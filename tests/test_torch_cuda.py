"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports no jax, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol = atol = 1e-4: shared-memory atomics change the order of the
bucket sums from run to run."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop
from repro_torch.core import losses
from repro_torch.core.completion import als
from repro_torch.core.completion import ccd
from repro_torch.core.completion import gauss_newton as ggn
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
    torch.testing.assert_close(kops.tttp_values(st, fs),
                               kref.tttp_ref(st.values, st.indices, st.valid,
                                             fs), **TOL)
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
@pytest.mark.parametrize("r", [1, 3, 10, 64, 160])
@pytest.mark.parametrize("missing", [None, 1])
def test_tttp_kernel_matches_plain_version(dev, r, missing):
    """The TTTP kernel at any R (float4 passes over R with the last float4
    masked; 160 takes ten passes), with a factor missing, on padding slots
    whose values are not zero (the kernel reads the valid mask and writes
    exact zeros there), over a ragged tail (m is not a multiple of the
    nonzeros a CTA takes per step), and over a bucket view."""
    from repro_torch.kernels import _build
    st, fs = _problem(dev, 4, (40, 24, 12), 3000, r)
    if missing is not None:
        fs[missing] = None
    vals = st.values.clone()
    vals[~st.valid] = 5.0
    raw = dataclasses.replace(st, values=vals)
    assert st.cap % (2 * _build.THREADS) != 0
    got = kops.tttp_values(raw, fs)
    torch.testing.assert_close(
        got, kref.tttp_ref(vals, st.indices, st.valid, fs), **TOL)
    assert bool((got[~st.valid] == 0).all())
    bk = st.row_buckets(0, 8)
    nb, c, nd = bk.indices.shape
    got = kops.tttp_bucket_values(bk, fs)
    want = kref.tttp_ref(bk.values.reshape(-1), bk.indices.reshape(-1, nd),
                         bk.valid.reshape(-1), fs).view(nb, c)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 2])
def test_bucketed_routes_at_rank_160_match_plain_versions(dev, mode):
    """R = 160: the MTTKRP as two column tiles (128 + 32 columns) and the
    Gram matvec as TTTP over the bucket view then the tiled MTTKRP."""
    st, fs = _problem(dev, 5, (40, 24, 12), 3000, 160)
    bk = st.row_buckets(mode, 8)
    others = list(fs)
    others[mode] = None
    kops.reset_launch_counts()
    torch.testing.assert_close(
        kops.mttkrp_bucketed(bk, others),
        kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row, others,
                                 mode, 8)[:st.shape[mode]], **TOL)
    assert kops.launch_counts() == {"tttp": 0, "mttkrp": 2, "cg_matvec": 0}
    x = 0.5 * torch.randn(st.shape[mode], 160, device=dev)
    torch.testing.assert_close(
        kops.cg_matvec_bucketed(bk, fs, x),
        kref.cg_matvec_bucketed_ref(bk.values, bk.indices, bk.local_row, fs,
                                    x, mode, 8)[:st.shape[mode]], **TOL)
    assert kops.launch_counts() == {"tttp": 1, "mttkrp": 4, "cg_matvec": 0}


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_bad_operands(dev):
    st, fs = _problem(dev, 1, (30, 20, 10), 800, 10)
    kops.reset_launch_counts()
    kops.tttp_values(st, fs)
    bk = st.row_buckets(0, 8)
    kops.mttkrp_bucketed(bk, [None] + fs[1:])
    kops.cg_matvec_bucketed(bk, fs, fs[0])
    assert kops.launch_counts() == {"tttp": 1, "mttkrp": 1, "cg_matvec": 1}
    vals, valid = st.values, st.valid
    with pytest.raises(TypeError):
        ktttp.tttp_cuda(vals.double(), st.indices, valid, fs)
    with pytest.raises(ValueError, match="contiguous"):
        ktttp.tttp_cuda(vals, st.indices, valid, [f.t().contiguous().t()
                                                  for f in fs])
    with pytest.raises(ValueError, match="CUDA device"):
        ktttp.tttp_cuda(vals, st.indices, valid, [fs[0].cpu()] + fs[1:])
    with pytest.raises(TypeError):
        ktttp.tttp_cuda(vals, st.indices, valid.float(), fs)
    # the fused kernel refuses R > 128; the ops route runs it as TTTP then
    # the MTTKRP, whose R = 129 takes two column tiles (128 + 1)
    wide = [torch.zeros(f.shape[0], 129, device=dev) for f in fs]
    with pytest.raises(ValueError, match="R=129"):
        kcg.cg_matvec_cuda(bk, wide, wide[0])
    kops.cg_matvec_bucketed(bk, wide, wide[0])
    kmttkrp.mttkrp_cuda(bk, [None] + wide[1:])
    assert kops.launch_counts() == {"tttp": 2, "mttkrp": 5, "cg_matvec": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("r", [6, 160])
@pytest.mark.parametrize("path", ["fused", "tttp_mttkrp"])
def test_als_sweep_on_card_matches_plain_path(dev, path, r):
    """One sweep on the card against the plain path on the CPU. At R = 160
    (both routes run TTTP over the bucket view and the MTTKRP in column
    tiles) each 160 × 160 system has at most 100 nonzeros and is held up by
    λ alone, and CG amplifies float32 rounding well past 1e-4: the plain
    path's own float32 sweep is about as far from its float64 sweep as the
    card's is from it. So at R = 160 the card is held to the float64 sweep,
    no further from it than three times the plain float32 sweep is."""
    st, fs = _problem(dev, 2, (40, 30, 20), 4000, r)
    omega = st.with_values(torch.ones_like(st.values))
    got = als.als_sweep(st, omega, fs, 1e-5, cg_iters=12, matvec_path=path)

    def plain(dtype):
        cpu = interop.sparse_from_numpy(
            st.indices.cpu().numpy(), st.values.cpu().to(dtype).numpy(),
            st.valid.cpu().numpy(), st.shape, "cpu")
        return als.als_sweep(cpu, cpu.with_values(torch.ones_like(cpu.values)),
                             [f.cpu().to(dtype) for f in fs], 1e-5,
                             cg_iters=12, matvec_path=path)

    want = plain(torch.float32)
    if r <= 128:
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, **TOL)
        return
    for d, (g, w, w64) in enumerate(zip(got, want, plain(torch.float64))):
        floor = float((w.double() - w64).abs().max())
        off = float((g.cpu().double() - w64).abs().max())
        assert off <= 3 * floor + 1e-4 * float(w64.abs().max()), (
            f"factor {d}: card {off:.3e} from the float64 sweep, plain "
            f"float32 {floor:.3e}")


def _on_cpu(st, fs, dtype):
    """The card's tensor and factors as CPU copies in ``dtype``."""
    cpu = interop.sparse_from_numpy(
        st.indices.cpu().numpy(), st.values.cpu().to(dtype).numpy(),
        st.valid.cpu().numpy(), st.shape, "cpu")
    return cpu, [f.cpu().to(dtype) for f in fs]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "tttp_mttkrp"])
def test_ggn_sweep_on_card_matches_plain_path(dev, path):
    """Two GGN iterations (poisson_log) on the card against the plain path
    on the CPU: the damping after each equal to the float64 plain run's,
    and the factors within 1e-4 of the float32 plain run, or, where float32
    rounding carried through the joint solve moves the plain float32 run
    itself further from the float64 run, no further from the float64 run
    than three times the plain float32 run is (the two packages' GGN runs
    agree to 2e-10 in float64 and lie 3e-4 apart in float32 after two
    iterations on the CPU). All three kernels launch on the fused route;
    TTTP and the MTTKRP on the other."""
    st, fs = _problem(dev, 3, (40, 30, 20), 4000, 6)
    it = dict(cg_iters=10, joint_iters=6, precond_iters=4,
              matvec_path=path)

    def run(t, factors):
        state, out = ggn.ggn_init(factors), []
        for _ in range(2):
            state = ggn.ggn_sweep(t, state, losses.poisson_log, 1e-5, **it)
            out.append(state)
        return out

    kops.reset_launch_counts()
    got = run(st, fs)
    torch.cuda.synchronize()
    n = kops.launch_counts()
    assert n["tttp"] > 0 and n["mttkrp"] > 0
    assert (n["cg_matvec"] > 0) == (path == "fused")
    want32 = run(*_on_cpu(st, fs, torch.float32))
    want64 = run(*_on_cpu(st, fs, torch.float64))
    for i, (g, w, w64) in enumerate(zip(got, want32, want64)):
        assert float(g.damping) == pytest.approx(float(w64.damping),
                                                 rel=1e-6), i
        for d, (gf, wf, wf64) in enumerate(zip(g.factors, w.factors,
                                               w64.factors)):
            gf = gf.cpu()
            if torch.allclose(gf, wf, **TOL):
                continue
            floor = float((wf.double() - wf64).abs().max())
            off = float((gf.double() - wf64).abs().max())
            assert off <= 3 * floor, (
                f"iteration {i} factor {d}: card {off:.3e} from the float64 "
                f"run, plain float32 {floor:.3e}")


@pytest.mark.cuda
def test_ccd_sweep_tttp_on_card_matches_plain_path(dev):
    """One CCD++ sweep through the TTTP kernel on vector factors: 2 TTTP
    launches per column update (2·N·R), and the factors and residual of the
    plain path on the CPU at rtol = atol = 1e-4."""
    st, fs = _problem(dev, 4, (40, 30, 20), 4000, 5)
    rho = ccd.residual_values(st, fs)
    kops.reset_launch_counts()
    got, got_rho = ccd.ccd_sweep_tttp(st, fs, rho, 0.1)
    torch.cuda.synchronize()
    assert kops.launch_counts()["tttp"] == 2 * 3 * 5
    cpu, cfs = _on_cpu(st, fs, torch.float32)
    want, want_rho = ccd.ccd_sweep_tttp(cpu, cfs, rho.cpu(), 0.1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)
    torch.testing.assert_close(got_rho.cpu(), want_rho, **TOL)
