"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports no jax, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol = atol = 1e-4: the kernels sum in another order than the
plain versions (in one order every run: two launches give the same bits,
``test_bucketed_launches_repeat_bit_for_bit``)."""
import dataclasses
import math
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
from repro_torch.kernels import tile as ktile
from repro_torch.kernels import tttp as ktttp
from repro_torch.planner import tuner

TOL = dict(rtol=1e-4, atol=1e-4)
# launches_by_dtype with every variant at 0
NO_LAUNCHES = dict.fromkeys(("float32", "bfloat16", "float64",
                             "float32/float64", "bfloat16/float64"), 0)


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
    threads = ktile.DEFAULT_TILE.threads
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
    assert bk.capacity % threads != 0                # a ragged last step
    if bk.capacity >= 2 * threads:
        # some thread's slots (c ≡ t mod threads) span more than one row
        lr = bk.local_row[:, :bk.capacity // threads * threads]
        runs = lr.reshape(bk.num_blocks, -1, threads)
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
    st, fs = _problem(dev, 4, (40, 24, 12), 3000, r)
    if missing is not None:
        fs[missing] = None
    vals = st.values.clone()
    vals[~st.valid] = 5.0
    raw = dataclasses.replace(st, values=vals)
    assert st.cap % (2 * ktile.DEFAULT_TILE.threads) != 0
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


# the reference's documented bf16 bound (tests/test_golden.py)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 10, 32, 160])
@pytest.mark.parametrize("sort_mode", [None, 0])
def test_bf16_kernels_match_plain_versions(dev, r, sort_mode):
    """The bf16 instantiations read bf16 values, factor rows and x, sum in
    float32 and write bf16; held against the plain versions on float32
    copies of the same bf16 inputs, compared in float32. The per-dtype
    counts show that the bf16 instantiation launched (R = 160: the MTTKRP
    in two column tiles, the matvec as TTTP then the MTTKRP)."""
    st, fs = _problem(dev, 7, (60, 40, 30), 3000, r, sort_mode)
    s16, f16 = st.astype(torch.bfloat16), [f.bfloat16() for f in fs]
    f32 = [f.float() for f in f16]
    kops.reset_launch_counts()
    got = kops.tttp_values(s16, f16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), kref.tttp_ref(s16.values.float(), st.indices, st.valid,
                                   f32), **BF16_TOL)
    om = s16.with_values(torch.ones_like(s16.values))
    for mode in (0, 2):
        bk, bo = s16.row_buckets(mode, 8), om.row_buckets(mode, 8)
        part = [None if d == mode else f for d, f in enumerate(f16)]
        got = kops.mttkrp_bucketed(bk, part)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), kref.mttkrp_bucketed_ref(
            bk.values.float(), bk.indices, bk.local_row,
            [None if f is None else f.float() for f in part], mode,
            8)[:st.shape[mode]], **BF16_TOL)
        x = f16[mode]
        got = kops.cg_matvec_bucketed(bo, f16, x)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), kref.cg_matvec_bucketed_ref(
            bo.values.float(), bo.indices, bo.local_row, f32, x.float(),
            mode, 8)[:st.shape[mode]], **BF16_TOL)
    by_dtype = kops.launch_counts_by_dtype()
    wide = r > kmttkrp.MAX_RANK
    assert by_dtype["tttp"] == {**NO_LAUNCHES, "bfloat16": 1 + 2 * wide}
    assert by_dtype["mttkrp"] == {**NO_LAUNCHES,
                                  "bfloat16": 2 * (1 + wide) * (1 + wide),
                                  "float64": 0}
    assert by_dtype["cg_matvec"] == {**NO_LAUNCHES,
                                     "bfloat16": 0 if wide else 2,
                                     "float64": 0}


def _held_f64(got, want):
    """chip_smoke.py phase 2's float64 limit: rtol 1e-10 plus 1e-12 of the
    largest plain entry (only the order of the sums differs)."""
    assert got.dtype == torch.float64 and got.shape == want.shape
    scale = float(want.abs().max())
    err = (got - want).abs()
    assert bool((err <= 1e-10 * want.abs() + 1e-12 * scale).all()), \
        f"max |kernel - plain| {float(err.max()):.3e}, max |plain| {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("r", [3, 10, 160])
def test_f64_kernels_match_plain_versions(dev, r):
    """The float64 instantiations against their plain versions in float64
    on the same inputs, at phase 2's tolerance; the per-dtype counts show
    float64 launches only."""
    st, fs = _problem(dev, 11, (60, 40, 30), 3000, r)
    s64, f64 = st.astype(torch.float64), [f.double() for f in fs]
    kops.reset_launch_counts()
    _held_f64(kops.tttp_values(s64, f64),
              kref.tttp_ref(s64.values, st.indices, st.valid, f64))
    om = s64.with_values(torch.ones_like(s64.values))
    for mode in (0, 2):
        bk, bo = s64.row_buckets(mode, 8), om.row_buckets(mode, 8)
        part = [None if d == mode else f for d, f in enumerate(f64)]
        _held_f64(kops.mttkrp_bucketed(bk, part), kref.mttkrp_bucketed_ref(
            bk.values, bk.indices, bk.local_row, part, mode,
            8)[:st.shape[mode]])
        x = f64[mode]
        _held_f64(kops.cg_matvec_bucketed(bo, f64, x),
                  kref.cg_matvec_bucketed_ref(
                      bo.values, bo.indices, bo.local_row, f64, x, mode,
                      8)[:st.shape[mode]])
    by_dtype = kops.launch_counts_by_dtype()
    wide = r > kmttkrp.MAX_RANK
    for k, c in by_dtype.items():
        assert c["float32"] == 0 and c["bfloat16"] == 0, k
        assert c["float64"] > 0 or (k == "cg_matvec" and wide), k


@pytest.mark.cuda
def test_mixed_inputs_promote_before_the_launch(dev):
    """Mixed float32 and bf16 operands run the promoted type's kernel (the
    reference's rule), and the result takes the reference's dtype: the
    matvec's weights stay out of it. float64 runs its own instantiation;
    float16 is refused."""
    st, fs = _problem(dev, 8, (40, 24, 12), 800, 10)
    f16 = [f.bfloat16() for f in fs]
    kops.reset_launch_counts()
    out = kops.tttp_values(st.astype(torch.bfloat16), fs)
    assert out.dtype == torch.float32
    bo = st.with_values(torch.ones_like(st.values)).row_buckets(0, 8)
    out = kops.cg_matvec_bucketed(bo, f16, f16[0])
    assert out.dtype == torch.bfloat16
    assert kops.launch_counts_by_dtype()["tttp"] == {**NO_LAUNCHES,
                                                     "float32": 1}
    assert kops.launch_counts_by_dtype()["cg_matvec"] == {**NO_LAUNCHES,
                                                          "float32": 1}
    out = kops.tttp_values(st.astype(torch.float64), fs)
    assert out.dtype == torch.float64
    assert kops.launch_counts_by_dtype()["tttp"]["float64"] == 1
    with pytest.raises(TypeError):
        kops.tttp_values(st.astype(torch.float16), [f.half() for f in fs])


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


# streamed layouts: the function stream sorted by linearized coordinate
# (mode 0's sel is monotone), and netflix-ci's Zipf-skewed buckets (mode 0's
# fullest bucket holds several times the mean)
STREAMED = [("function", (60, 40, 20), 20_000, 4_096),
            ("netflix", (80, 60, 20), 15_000, 4_096)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,nnz,chunk", STREAMED)
def test_kernels_on_streamed_layouts_match_plain_versions(dev, kind, shape,
                                                          nnz, chunk):
    from repro_torch.data import streaming
    from repro_torch.data.pipeline import CompletionDataset
    ds = CompletionDataset.from_stream(
        streaming.make_stream(kind, 0, shape, nnz, chunk), shape,
        test_fraction=0.1, device=dev)
    st = ds.tensor
    assert st.device.type == "cuda" and st.sorted_mode == 0
    rng = np.random.default_rng(1)
    fs = interop.factors_from_numpy(
        [(0.5 * rng.standard_normal((s, 6))).astype(np.float32)
         for s in shape], dev)
    kops.reset_launch_counts()
    torch.testing.assert_close(kops.tttp_values(st, fs),
                               kref.tttp_ref(st.values, st.indices, st.valid,
                                             fs), **TOL)
    for mode in range(3):
        bk = st.row_buckets(mode, ds.block_rows)
        others = list(fs)
        others[mode] = None
        torch.testing.assert_close(
            kops.mttkrp_bucketed(bk, others),
            kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                     others, mode,
                                     ds.block_rows)[:shape[mode]], **TOL)
        om = ds.omega.row_buckets(mode, ds.block_rows)
        torch.testing.assert_close(
            kops.cg_matvec_bucketed(om, fs, fs[mode]),
            kref.cg_matvec_bucketed_ref(om.values, om.indices, om.local_row,
                                        fs, fs[mode], mode,
                                        ds.block_rows)[:shape[mode]], **TOL)
    assert kops.launch_counts() == {"tttp": 1, "mttkrp": 3, "cg_matvec": 3}
    if kind == "netflix":
        occ = st.row_buckets(0, ds.block_rows).valid.sum(1).float()
        assert float(occ.max()) > 3 * float(occ.mean())
    m = streaming.heldout_metrics(ds.test, fs)
    assert kops.launch_counts()["tttp"] == 2
    assert math.isfinite(m["rmse"]) and m["count"] == ds.test.nnz


@pytest.mark.cuda
def test_checkpoint_round_trip_restores_onto_card(dev, tmp_path):
    from repro_torch.checkpoint import checkpointer as ckpt
    fs = [torch.randn(d, 4, device=dev) for d in (7, 5, 3)]
    state = ggn.ggn_init(fs, damping=0.5)
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save_async(2, state, {"note": "card"})
    fs[0].zero_()                  # the async save copied to the host first
    ck.wait()
    like = ggn.ggn_init([torch.zeros_like(f) for f in fs])
    got, man = ckpt.restore(str(tmp_path), 2, like)
    assert man["metadata"] == {"note": "card"}
    assert all(f.device.type == "cuda" for f in got.factors)
    assert got.damping.device.type == "cuda" and float(got.damping) == 0.5
    assert not bool((got.factors[0] == 0).all())
    for g, w in zip(got.factors[1:], fs[1:]):
        assert torch.equal(g, w)
    cpu, _ = ckpt.restore(str(tmp_path), 2, ckpt.tree_map(
        lambda t: t.cpu(), like))
    assert all(f.device.type == "cpu" for f in cpu.factors)


@pytest.mark.cuda
def test_span_fences_card_work_and_is_a_noop_under_graph_capture(dev):
    """A device span times its card work with CUDA events and returns
    before that work is done (no fence: only reading the registry waits);
    under graph capture a span is a no-op."""
    from repro_torch import obs
    a = torch.randn(4096, 4096, device=dev)
    obs.enable()
    obs.get_registry().reset()
    try:
        torch.cuda.synchronize()
        with obs.span("matmul", device=True) as sp:
            for _ in range(20):
                b = a @ a
        assert sp.record["dur_s"] > 0
        assert not torch.cuda.current_stream().query()   # not fenced
        (e,) = obs.get_registry().spans("matmul")        # waits here
        assert torch.cuda.current_stream().query()
        # 20 products of 4096^2 at most at the card's fp32 peak, 67
        # TFLOP/s: the device time is no shorter than that bound
        assert e.device_s >= 20 * 2 * 4096 ** 3 / 67e12
        x = torch.ones(8, device=dev)
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            y = x * 2                                   # warm-up
            with torch.cuda.graph(g):
                with obs.span("captured", device=True) as cap:
                    assert not cap.live and obs.capturing()
                    y = x * 2
                obs.counter_add("captured")
        torch.cuda.current_stream().wait_stream(s)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, x * 2)
        summ = obs.get_registry().summary()
        assert set(summ["timings"]) == {"matmul"}
        assert summ["timings"]["matmul"]["device_count"] == 1
        assert summ["counters"] == {}
    finally:
        obs.disable()
        obs.get_registry().reset()


# ---------------------------------------------------------------------------
# serving: the engine's CUDA graphs
# ---------------------------------------------------------------------------

def _serve_case(seed, shape, r, users, nnz):
    """numpy factors, score queries, top-k fixed indices and histories."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal((s, r)) / np.sqrt(r)).astype(np.float32)
              for s in shape]
    queries = np.stack([rng.integers(0, s, 300) for s in shape], 1)
    fixed = {0: rng.integers(0, shape[0], 40), 2: rng.integers(0, shape[2],
                                                               40)}
    hists = [(np.stack([rng.integers(0, shape[d], nnz) for d in (1, 2)], 1),
              rng.standard_normal(nnz).astype(np.float32))
             for _ in range(users)]
    return arrays, queries.astype(np.int32), fixed, hists


@pytest.mark.cuda
@pytest.mark.parametrize("r", [10, 32])
def test_serve_engine_on_card_matches_cpu(dev, r):
    """All three endpoints through captured graphs against the eager CPU
    engine (plain versions); R = 32 takes the fused body at RMAX 32.
    Scores rtol 1e-5 (float32 sums in another order), fold-in 1e-4."""
    from repro_torch import serve
    arrays, queries, fixed, hists = _serve_case(r, (500, 300, 40), r, 37, 25)
    cpu = serve.ServeEngine(interop.serving_model_from_numpy(
        arrays, "log", device="cpu"), max_batch=128, topk_block=64,
        device="cpu")
    card = serve.ServeEngine(interop.serving_model_from_numpy(
        arrays, "log", device=dev), max_batch=128, topk_block=64, device=dev)
    for _ in range(2):                          # capture, then replay
        np.testing.assert_allclose(card.score(queries), cpu.score(queries),
                                   rtol=1e-5, atol=1e-6)
        cv, ci = card.top_k(fixed, 1, 10)
        pv, _ = cpu.top_k(fixed, 1, 10)
        np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-6)
        # indices held through the scores they select (torch.topk on the
        # card does not order ties): the float64 score of every returned
        # item is its returned value
        full = np.exp(np.clip((arrays[0][fixed[0]].astype(np.float64)
                               * arrays[2][fixed[2]]) @ arrays[1].T,
                              -30, 30))
        np.testing.assert_allclose(np.take_along_axis(full, ci, 1), cv,
                                   rtol=1e-5, atol=1e-6)
        assert all(len(set(row)) == 10 for row in ci.tolist())
        np.testing.assert_allclose(card.fold_in(hists, 0),
                                   cpu.fold_in(hists, 0), **TOL)
    # score batches 128, 128, 44: graphs of buckets 128 and 64, replayed
    # 1 + 3 times; top-k and fold-in one graph each, replayed once
    stats = card.graph_stats()
    assert stats["captured"] == 4 and stats["replays"] == 6


@pytest.mark.cuda
def test_graph_replay_equals_eager_call(dev):
    """A replay over new inputs gives what an eager call on them gives."""
    from repro_torch import serve
    from repro_torch.serve import foldin
    arrays, queries, fixed, hists = _serve_case(1, (400, 200, 30), 32, 20,
                                                30)
    model = interop.serving_model_from_numpy(arrays, device=dev)
    eng = serve.ServeEngine(model, max_batch=64, device=dev)
    eng.score(queries[:64])
    eng.fold_in(hists[:10], 0)
    assert eng.graph_stats()["captured"] == 2
    got = eng.score(queries[64:128])                     # replay
    want = serve.model.multilinear_scores(
        model.factors, torch.from_numpy(queries[64:128]).to(dev))
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-6,
                               atol=1e-7)
    rows = eng.fold_in(hists[10:], 0)                    # replay
    assert eng.graph_stats()["replays"] == 2
    st = foldin.pack_histories(hists[10:], model.shape, 0, device=dev)
    eager, _ = foldin.fold_in(st, model.factors, 0)
    np.testing.assert_allclose(rows, eager.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_replays_count_the_launches_of_eager_calls(dev):
    """N calls of one bucket count N times the kernel launches of one eager
    call: the capture counts nothing, each replay what its graph holds."""
    from repro_torch import serve
    from repro_torch.serve import foldin
    arrays, queries, _, hists = _serve_case(2, (300, 200, 30), 32, 16, 20)
    model = interop.serving_model_from_numpy(arrays, device=dev)
    st = foldin.pack_histories(hists, model.shape, 0, device=dev)
    kops.reset_launch_counts()
    foldin.fold_in(st, model.factors, 0)
    eager_fold = kops.launch_counts()
    assert eager_fold == {"tttp": 0, "mttkrp": 1, "cg_matvec": 1 + 128}
    eng = serve.ServeEngine(model, device=dev)
    n = 5
    kops.reset_launch_counts()
    for _ in range(n):
        eng.score(queries[:50])
    assert kops.launch_counts() == {"tttp": n, "mttkrp": 0, "cg_matvec": 0}
    kops.reset_launch_counts()
    for _ in range(n):
        eng.fold_in(hists, 0)
    assert kops.launch_counts() == {k: n * v for k, v in eager_fold.items()}
    assert eng.graph_stats()["replays"] == 2 * (n - 1)


@pytest.mark.cuda
def test_fold_in_replays_count_their_cg_iterations(dev):
    """With tracing live, a fold-in replay adds its CG budget and the
    graph's own count of active iterations, read in the rows' copy, to the
    counters (the eager first call counted in its solve), and tracing
    leaves each graph's launches and rows as they were."""
    from repro_torch import obs, serve
    from repro_torch.serve import foldin
    arrays, _, _, hists = _serve_case(3, (300, 200, 30), 32, 16, 20)
    model = interop.serving_model_from_numpy(arrays, device=dev)
    plain = serve.ServeEngine(model, device=dev)
    for _ in range(2):
        want = plain.fold_in(hists, 0)
    traced = serve.ServeEngine(model, device=dev)
    budget = foldin.cg_budget(32)
    obs.enable()
    obs.get_registry().reset()
    try:
        traced.fold_in(hists, 0)             # eager first call, captured
        reg = obs.get_registry()
        first = reg.summary()["counters"]
        for _ in range(2):                   # two replays
            got = traced.fold_in(hists, 0)
        counters = reg.summary()["counters"]
        log = reg.counter_log("cg/")
        names = [e.name for e in reg.spans("serve/")]
    finally:
        obs.disable()
        obs.get_registry().reset()
    assert traced.graph_stats()["replays"] == 2
    assert first["cg/iterations"] == budget
    assert 0 < first["cg/active_iterations"] <= budget
    assert counters["cg/iterations"] == 3 * budget
    assert counters["cg/active_iterations"] == \
        3 * first["cg/active_iterations"]
    assert len(log) == 6
    assert names.count("serve/graph/replay") == 2
    assert names.count("serve/graph/capture") == 1
    assert names.count("serve/fold_in/pack") == 3
    assert traced.graph_stats()["launches_per_replay"] == \
        plain.graph_stats()["launches_per_replay"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_wrappers_refuse_inputs_that_require_grad(dev):
    """The CUDA kernels have no backward: with grad mode on, an input that
    requires grad raises instead of returning an output without a grad_fn;
    under no_grad, or with detached inputs, they launch."""
    st, fs = _problem(dev, 7, (40, 24, 12), 3000, 6)
    bk = st.row_buckets(0, 8)
    x = fs[0].clone()
    leaf = fs[1].clone().requires_grad_()
    grad_fs = [None, leaf, fs[2]]
    with pytest.raises(RuntimeError, match="no backward"):
        kops.tttp_values(st, [fs[0], leaf, fs[2]])
    with pytest.raises(RuntimeError, match="no backward"):
        kops.mttkrp_bucketed(bk, grad_fs)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.cg_matvec_bucketed(bk, grad_fs, x)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.mttkrp_bucketed(dataclasses.replace(
            bk, values=bk.values.clone().requires_grad_()), [None, *fs[1:]])
    with torch.no_grad():
        out = kops.mttkrp_bucketed(bk, grad_fs)
    np.testing.assert_allclose(
        out.cpu().numpy(),
        kops.mttkrp_bucketed(bk, [None, *fs[1:]]).cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_planner_paths_on_card_match_cpu(dev):
    """Every candidate of the four families the solvers use, through
    ``ctf.einsum`` on the card, against the same call on the CPU; the
    all-at-once, bucketed and fused paths launch their kernels."""
    import repro_torch.core.api as ctf
    st, fs = _problem(dev, 8, (60, 40, 30), 6000, 8)
    cst, cfs = _on_cpu(st, fs, torch.float32)
    x, cx = fs[0] * 0.5, cfs[0] * 0.5
    cases = {"ijk,jr,kr->ir": ((fs[1], fs[2]), (cfs[1], cfs[2])),
             "ijk,ir,jr,kr->ijk": (tuple(fs), tuple(cfs)),
             "ijk,jr,kr,iy,jy,ky->ir": ((fs[1], fs[2], x, fs[1], fs[2]),
                                        (cfs[1], cfs[2], cx, cfs[1],
                                         cfs[2])),
             "ijk->j": ((), ())}
    kernel_of = {("ijk,jr,kr->ir", "all_at_once"): "mttkrp",
                 ("ijk,jr,kr->ir", "bucketed"): "mttkrp",
                 ("ijk,ir,jr,kr->ijk", "all_at_once"): "tttp",
                 ("ijk,ir,jr,kr->ijk", "sliced"): "tttp",
                 ("ijk,jr,kr,iy,jy,ky->ir", "fused"): "cg_matvec",
                 ("ijk,jr,kr,iy,jy,ky->ir", "tttp_mttkrp"): "mttkrp",
                 ("ijk,jr,kr,iy,jy,ky->ir", "sliced"): "mttkrp"}
    for expr, (dense, cdense) in cases.items():
        for path in ctf.plan(expr, st, *dense).candidates:
            kops.reset_launch_counts()
            got = ctf.einsum(expr, st, *dense, path=path)
            counts = kops.launch_counts()
            want = ctf.einsum(expr, cst, *cdense, path=path, device="cpu")
            if hasattr(got, "todense"):
                got, want = got.values, want.values
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-3,
                                       err_msg=f"{expr} via {path}")
            kernel = kernel_of.get((expr, path))
            assert (counts[kernel] > 0) if kernel else \
                not any(counts.values()), (expr, path, counts)


@pytest.mark.cuda
def test_engine_planner_paths_capture_and_replay(dev):
    """score_path and the planner's fold-in matvec through captured graphs:
    the plans are built in each key's eager first call, the replays match
    the CPU engine."""
    from repro_torch import planner, serve
    arrays, queries, _, hists = _serve_case(3, (300, 200, 30), 10, 12, 20)
    kw = dict(max_batch=64, score_path="all_at_once",
              foldin_matvec_path="sliced")
    card = serve.ServeEngine(interop.serving_model_from_numpy(
        arrays, device=dev), device=dev, **kw)
    cpu = serve.ServeEngine(interop.serving_model_from_numpy(
        arrays, device="cpu"), device="cpu", **kw)
    planner.clear_plan_cache()
    for _ in range(2):                          # capture, then replay
        np.testing.assert_allclose(card.score(queries[:50]),
                                   cpu.score(queries[:50]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(card.fold_in(hists, 0),
                                   cpu.fold_in(hists, 0), **TOL)
    assert card.graph_stats()["replays"] == 2


# every tile the tuner's lattices hold, at two ranks (RMAX 16 and 32 of the
# bucketed body, TTTP's one 16-column pass and two)
LATTICE_TILES = sorted({t for lat in tuner.LATTICES.values() for t in lat},
                       key=lambda t: t.short())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [10, 32])
@pytest.mark.parametrize("tile", LATTICE_TILES, ids=lambda t: t.short())
def test_lattice_tiles_match_plain_versions(dev, tile, r):
    """Each lattice candidate of the three kernels against its plain
    version, launched in its own shape (``last_launch``)."""
    st, fs = _problem(dev, 9, (60, 30, 20), 6000, r)
    got = kops.tttp_values(st, fs, tile=tile)
    torch.testing.assert_close(
        got, kref.tttp_ref(st.values, st.indices, st.valid, fs), **TOL)
    assert ktttp.last_launch == (tile.threads, tile.per_thread)
    bk = st.row_buckets(0, 8)
    others = [None] + fs[1:]
    torch.testing.assert_close(
        kops.mttkrp_bucketed(bk, others, tile=tile),
        kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                 others, 0, 8)[:60], **TOL)
    assert kmttkrp.last_launch == (tile.threads, tile.per_thread)
    x = 0.5 * torch.randn(60, r, device=dev)
    torch.testing.assert_close(
        kops.cg_matvec_bucketed(bk, fs, x, tile=tile),
        kref.cg_matvec_bucketed_ref(bk.values, bk.indices, bk.local_row, fs,
                                    x, 0, 8)[:60], **TOL)
    assert kcg.last_launch == (tile.threads, tile.per_thread)


@pytest.mark.cuda
def test_kernel_attributes_match_footprint_model(dev):
    """The attribute entry point answers for every instantiation of the
    lattices' depths, its registers and static shared memory are the
    build log's (what the footprint model reads), and a made-up
    instantiation raises."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import footprint
    _build.lib()
    usage = _build.resource_usage()
    assert usage, "no build log beside the library"
    for depth, (dt, acc) in ((d, v) for d in ktile.PER_THREAD_DEPTHS
                             for v in _build.VARIANTS):
        # the element type, then the accumulator where it is wider
        name = (_build.dtype_name(dt),) + (
            () if acc == _build.natural_accumulator(dt)
            else (_build.dtype_name(acc),))
        for family, variants, key in (
                ("tttp", range(1, 9),
                 lambda v: ("tttp_kernel", (v, depth, *name))),
                ("mttkrp", footprint.RMAX_VARIANTS,
                 lambda v: ("bucket_rows_kernel", (v, 0, depth, *name))),
                ("cg_matvec", footprint.RMAX_VARIANTS,
                 lambda v: ("bucket_rows_kernel", (v, 1, depth, *name)))):
            for v in variants:
                a = _build.kernel_attributes(family, v, depth, 256, 768, dt,
                                             acc)
                log = usage[key(v)]
                assert a["registers"] == log["registers"], (family, v, depth,
                                                            name)
                assert a["static_smem"] == log["smem"], (family, v, depth,
                                                         name)
                assert a["max_threads"] >= 256 and a["blocks_per_sm"] >= 1
    with pytest.raises(RuntimeError, match="kernel attributes"):
        _build.kernel_attributes("tttp", 9, 2, 256, 0)
    with pytest.raises(RuntimeError, match="kernel attributes"):
        _build.kernel_attributes("mttkrp", 16, 3, 256, 0)


# ---------------------------------------------------------------------------
# distribution on the card: two gloo ranks sharing it (nccl refuses two
# ranks on one card), each launching the kernels on its own shard
# ---------------------------------------------------------------------------

_CARD_RANKS = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
sys.path.insert(0, os.environ["REPRO_PORT"])
from repro_torch import interop
from repro_torch.core.distributed import (DistLayout, mttkrp_rowsharded,
                                          sparse_allreduce_butterfly)
from repro_torch.kernels import ops as kops


def rank_main(rank, inp, outdir):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(outdir, "store"), 2), rank=rank, world_size=2)
    try:
        z = dict(np.load(inp))
        lay = DistLayout((2,), ("data",), None, ("data",))
        ctx = lay.ctx
        st = lay.shard(interop.sparse_from_numpy(
            z["idx"], z["vals"], z["valid"], tuple(z["shape"]), "cuda"))
        fs = interop.factors_from_numpy([z["f0"], z["f1"], z["f2"]], "cuda")
        kops.reset_launch_counts()
        out = {"tttp": kops.tttp_values(st, fs).cpu().numpy()}
        rows = [lay.slice(f, ("data", None)) for f in fs]
        out["rs_mttkrp"] = mttkrp_rowsharded(st, rows, 0, ctx,
                                             h_slices=2).cpu().numpy()
        b = interop.sparse_from_numpy(z["bf_idx"][rank], z["bf_vals"][rank],
                                      z["bf_valid"][rank], (32, 8), "cuda")
        out["butterfly"] = sparse_allreduce_butterfly(b).todense() \
            .cpu().numpy()
        n = kops.launch_counts()
        out["launches"] = np.array([n["tttp"], n["mttkrp"]])
        np.savez(os.path.join(outdir, f"rank_{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    from repro_torch.kernels import _build
    _build.build()
    mp.start_processes(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=2,
                       join=True, start_method="spawn")
    print("CARD-RANKS-OK")
"""

_CARD_RUN = {}


def _card_ranks(tmp_path_factory):
    """Run the two ranks once; their records and the inputs."""
    if not _CARD_RUN:
        import subprocess
        tmp = tmp_path_factory.mktemp("card_ranks")
        rng = np.random.default_rng(3)
        shape, nnz, cap = (64, 48, 32), 3000, 3072
        idx = np.stack([rng.integers(0, s, cap) for s in shape], 1) \
            .astype(np.int32)
        z = {"idx": idx, "vals": rng.uniform(0, 1, cap).astype(np.float32),
             "valid": np.arange(cap) < nnz, "shape": np.array(shape)}
        for d, s in enumerate(shape):
            z[f"f{d}"] = rng.standard_normal((s, 10)).astype(np.float32)
        bl = [(rng.integers(0, 32, (64, 2)).astype(np.int32),
               rng.standard_normal(64).astype(np.float32),
               np.arange(64) < 40) for _ in range(2)]
        for k, i in (("bf_idx", 0), ("bf_vals", 1), ("bf_valid", 2)):
            z[k] = np.stack([b[i] for b in bl])
        z["bf_idx"][:, :, 1] %= 8
        np.savez(tmp / "in.npz", **z)
        (tmp / "ranks.py").write_text(_CARD_RANKS)
        env = dict(os.environ, REPRO_PORT=os.path.abspath(PORT))
        out = subprocess.run([sys.executable, str(tmp / "ranks.py"),
                              str(tmp / "in.npz"), str(tmp)], env=env,
                             capture_output=True, text=True, timeout=600)
        assert "CARD-RANKS-OK" in out.stdout, out.stdout + out.stderr
        _CARD_RUN["z"] = z
        _CARD_RUN["ranks"] = [dict(np.load(tmp / f"rank_{r}.npz"))
                              for r in range(2)]
    return _CARD_RUN["z"], _CARD_RUN["ranks"]


def _cpu_tensor(z):
    return interop.sparse_from_numpy(z["idx"], z["vals"], z["valid"],
                                     tuple(z["shape"]), "cpu")


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_run_tttp(dev, tmp_path_factory):
    """Each rank launches TTTP on its half of the nonzeros; the halves
    joined equal the plain version on the whole tensor."""
    z, ranks = _card_ranks(tmp_path_factory)
    fs = interop.factors_from_numpy([z["f0"], z["f1"], z["f2"]], "cpu")
    want = kops.tttp_values(_cpu_tensor(z), fs).numpy()
    got = np.concatenate([r["tttp"] for r in ranks])
    np.testing.assert_allclose(got, want, **TOL)
    assert all(int(r["launches"][0]) >= 1 for r in ranks)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_run_rowsharded_mttkrp(
        dev, tmp_path_factory):
    """The row-sharded MTTKRP at h_slices 2 (gathers through host memory,
    the bucketed kernel per slice, a reduce-scatter) equals the plain
    MTTKRP's row blocks."""
    from repro_torch.sparse import ops as sops
    z, ranks = _card_ranks(tmp_path_factory)
    fs = interop.factors_from_numpy([z["f0"], z["f1"], z["f2"]], "cpu")
    want = sops.mttkrp(_cpu_tensor(z), [None, fs[1], fs[2]], 0).numpy()
    got = np.concatenate([r["rs_mttkrp"] for r in ranks])
    np.testing.assert_allclose(got, want, **TOL)
    assert all(int(r["launches"][1]) == 2 for r in ranks)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_run_the_butterfly(dev, tmp_path_factory):
    """The butterfly sparse all-reduce of the two ranks' blocks: both end
    with their dense sum."""
    z, ranks = _card_ranks(tmp_path_factory)
    dense = np.zeros((32, 8))
    for r in range(2):
        keep = z["bf_valid"][r]
        np.add.at(dense, tuple(z["bf_idx"][r][keep].T), z["bf_vals"][r][keep])
    for r in ranks:
        np.testing.assert_allclose(r["butterfly"], dense, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_ggn_iteration_in_float64_on_card_matches_the_cpu():
    """One GGN iteration (poisson_log, fused matvec) in float64 on the card
    against the same iteration on the CPU's plain versions in float64: the
    damping exactly and the factors within 1e-8 (the atomics' order is the
    only difference); every launch a float64 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (CUDA kernels have no CPU "
                    "mode)")
    st, fs = _problem(torch.device("cuda"), 5, (40, 30, 20), 4000, 6)
    it = dict(cg_iters=10, joint_iters=6, precond_iters=4)
    st64, fs64 = st.astype(torch.float64), [f.double() for f in fs]
    kops.reset_launch_counts()
    got = ggn.ggn_sweep(st64, ggn.ggn_init(fs64), losses.poisson_log, 1e-5,
                        **it)
    torch.cuda.synchronize()
    for k, c in kops.launch_counts_by_dtype().items():
        assert c["float64"] > 0 and c["float32"] == 0 and \
            c["bfloat16"] == 0, k
    cpu, cfs = _on_cpu(st, fs, torch.float64)
    want = ggn.ggn_sweep(cpu, ggn.ggn_init(cfs), losses.poisson_log, 1e-5,
                         **it)
    assert float(got.damping) == float(want.damping)
    for d, (g, w) in enumerate(zip(got.factors, want.factors)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-8, atol=1e-8,
                                   msg=lambda m: f"factor {d}: {m}")


def _held_one_rounding(got, want, dtype):
    """chip_smoke.py phase 2's limit for a float64 accumulator over
    ``dtype`` operands: one unit in the last place of ``dtype`` at |plain|
    plus 1e-12 of the largest plain entry (``want`` is float64)."""
    assert got.dtype == dtype and got.shape == want.shape
    want = want.to(dtype).double()
    bits = {torch.float32: 24, torch.bfloat16: 8}[dtype]
    _, e = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), e - bits)
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    assert bool((err <= ulp + 1e-12 * scale).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("r", [3, 10, 64])
def test_float64_accumulator_kernels_match_plain_versions(dev, dtype, r):
    """``KernelTile(accum_dtype="float64")`` over float32 and bf16 operands:
    each kernel's ``<T, double>`` instantiation against its plain version
    with a float64 accumulator within one rounding of the output type, and
    the counts show those instantiations alone."""
    tile = ktile.KernelTile(accum_dtype="float64")
    f64 = torch.float64
    st, fs = _problem(dev, 13, (60, 40, 30), 3000, r)
    sd, fd = st.astype(dtype), [f.to(dtype) for f in fs]
    kops.reset_launch_counts()
    _held_one_rounding(kops.tttp_values(sd, fd, tile),
                       kref.tttp_ref(sd.values, st.indices, st.valid, fd,
                                     f64), dtype)
    om = sd.with_values(torch.ones_like(sd.values))
    for mode in (0, 2):
        bk, bo = sd.row_buckets(mode, 8), om.row_buckets(mode, 8)
        part = [None if d == mode else f for d, f in enumerate(fd)]
        _held_one_rounding(
            kops.mttkrp_bucketed(bk, part, tile=tile),
            kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                     part, mode, 8, f64)[:st.shape[mode]],
            dtype)
        x = fd[mode]
        _held_one_rounding(
            kops.cg_matvec_bucketed(bo, fd, x, tile=tile),
            kref.cg_matvec_bucketed_ref(bo.values, bo.indices, bo.local_row,
                                        fd, x, mode, 8, f64)[:st.shape[mode]],
            dtype)
    label = f"{str(dtype)[6:]}/float64"
    for k, c in kops.launch_counts_by_dtype().items():
        assert c[label] > 0 and sum(c.values()) == c[label], (k, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,accum", [
    (torch.float32, "float32"), (torch.bfloat16, "float32"),
    (torch.float64, "float32"), (torch.float32, "float64"),
    (torch.bfloat16, "float64")],
    ids=["float32", "bfloat16", "float64", "float32-acc64", "bf16-acc64"])
def test_bucketed_launches_repeat_bit_for_bit(dev, dtype, accum):
    """Two launches of each bucketed kernel on the same inputs give the
    same bits in every instantiation (each warp sums into a shared slab of
    its own, the slabs added in warp order), on buckets whose warps flush
    rows of several kinds (sorted and shuffled, a warp's slots across
    three rows)."""
    tile = ktile.KernelTile(accum_dtype=accum)
    for shape, nnz, sort_mode in (((400, 30, 20), 600, None),
                                  ((60, 40, 30), 6000, 0),
                                  ((203, 77, 64), 10000, None)):
        st, fs = _problem(dev, 17, shape, nnz, 10, sort_mode)
        sd, fd = st.astype(dtype), [f.to(dtype) for f in fs]
        om = sd.with_values(torch.ones_like(sd.values))
        for mode in (0, 2):
            bk, bo = sd.row_buckets(mode, 8), om.row_buckets(mode, 8)
            part = [None if d == mode else f for d, f in enumerate(fd)]
            a = kops.mttkrp_bucketed(bk, part, tile=tile)
            assert torch.equal(a, kops.mttkrp_bucketed(bk, part, tile=tile))
            x = fd[mode]
            a = kops.cg_matvec_bucketed(bo, fd, x, tile=tile)
            assert torch.equal(a, kops.cg_matvec_bucketed(bo, fd, x,
                                                          tile=tile))
