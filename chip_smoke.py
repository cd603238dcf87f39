#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``port/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout this file sits in. It runs
seven phases and stops with a non-zero exit at the first failure:

1. build the CUDA kernels from ``port/repro_torch/csrc`` with nvcc for
   sm_90a and print each kernel's registers and spills;
2. hold each kernel against its plain PyTorch version on the card: R = 1,
   3, 10, 64 and 160 (all but 64 padded to a 16-byte row stride; 160 is
   wider than one launch of the bucketed body, so the MTTKRP runs in column
   tiles and the Gram matvec as TTTP over the bucket view then the MTTKRP,
   which the launch counts must show), block_rows 8 and 16, orders 3 and 4,
   empty buckets, padding slots, a bucket capacity that is not a multiple of
   the CTA's step, threads whose slots cross rows (the running sums flush
   inside the capacity loop), warps whose slots hold three rows, tensors
   sorted and not sorted by the bucketed mode (monotone and shuffled
   ``sel``), a missing factor; TTTP also on padding slots whose values are
   not zero (it must give exact zeros there), over a ragged tail and over a
   bucket view; the run fails unless every one of these layouts occurred;
   rtol = atol = 1e-4 (shared-memory atomics change the order of the bucket
   sums from run to run);
3. run implicit-CG ALS through ``repro_torch.launch.complete``: the function
   tensor at dims 20000^3 with 80 M nonzeros (density 1e-5, paper Fig. 7a),
   rank 10, 20 CG iterations, block_rows 8, two sweeps on the fused matvec,
   with every kernel's launch count zeroed before and read after; RMSE must
   be finite and fall, and each kernel must have launched. Then one sweep on
   the TTTP + bucketed-MTTKRP matvec from the same start, counts zeroed
   before and read after, whose time is printed and whose factors must
   match the fused run's first sweep at rtol 1e-3 (atol 1e-3 of the
   factor's largest entry): CG carries the two routes' different summation
   orders through 20 iterations and three modes;
4. hold each kernel, through the ``kernels.ops`` wrapper the main path
   calls, against its plain version on the main path's tensors (rtol 1e-4,
   atol 1e-5 of the largest plain entry; a disagreement fails the run),
   then time each with CUDA events at those shapes (the wrappers' time
   includes their padded copies of the factors and x), beside its plain
   version, the one PyTorch call that computes the same function where
   there is one, and the least time the card could take (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger), and
   the L2 sector bytes of its factor-row gathers, computed from the shapes,
   and the rate that implies. TTTP is timed twice: as the RMSE calls it
   (COO) and as the ``tttp_mttkrp`` matvec calls it (Ω's bucket view);
5. profile one fused sweep and one ``tttp_mttkrp`` sweep with
   torch.profiler: device time by kernel, the device's idle share of the
   sweep, and the costliest device kernels with their launch counts (the
   bucket values were gathered in phase 3, once per tensor and mode, and
   the ``tttp_mttkrp`` route gathers none per call, so no gather of 81 M
   values shows here);
6. run the generalized-loss solvers at full width on phase 3's dataset and
   initial factors (no second ingest), each run through
   ``repro_torch.launch.complete.run_solver`` with the launch counts zeroed
   before and read after: two GGN iterations (``poisson_log``, fused
   matvec, the reference's defaults: 20 CG, 15 joint and 8 preconditioner
   iterations, damping 1e-5), whose objective must be finite, must not rise
   and must fall over the two, each launching all three kernels; the fused
   matvec at the curvature weights against its plain version; one
   ``ggn_update_mode`` (quadratic, damping 0, mode 0) against
   ``als_update_mode`` from the same factors, both to a 1e-8 residual in 40
   CG iterations, at rtol 2e-3 (atol 2e-3 of the largest entry); one sweep
   of each CCD++ variant, whose RMSE must fall and whose factors must agree
   at rtol 1e-3 (atol 1e-3 of the largest entry), the TTTP variant
   launching TTTP 2·N·R times in its sweep; TTTP on vector factors (as
   CCD++ calls it) held against its plain version and timed; one Adam step
   of GCP (``poisson_log``, lr 1e-3) and one SGD sweep (sample rate 0.1),
   finite, each launching TTTP and the MTTKRP, with the share of the SGD
   sweep that the sample's bucket patterns take, and the MTTKRP held on a
   sample's bucket view; then one GGN iteration under torch.profiler;
7. print the kernel table as one JSON line (each row with its launches in
   the main path's run, and in every run of phases 3 and 6 under
   ``path_launches``), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "port"))

# H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# main path (phase 3): paper Fig. 7a density on one card
DIMS = (20000, 20000, 20000)
NNZ = 80_000_000
RANK = 10
CG_ITERS = 20
BLOCK_ROWS = 8
SWEEPS = 2
SEED = 0

CHECK_TOL = dict(rtol=1e-4, atol=1e-4)
# phase 4 at the main path's shapes: rtol, and atol as a share of max |plain|
MAIN_RTOL = 1e-4
MAIN_ATOL_OF_MAX = 1e-5


def log(msg):
    print(msg, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, n_ops):
    """Least time (ms) for the work and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_sector_bytes(n_rows, r):
    """L2 sector bytes that gathering ``n_rows`` factor rows takes when each
    row is read whole at the bucketed kernels' padded stride (R rounded up
    to 4 floats): the 32-byte sectors a row spans, averaged over the row
    offsets, which repeat every 8 rows."""
    stride = 4 * (-(-r // 4) * 4)
    spans = [(i * stride + stride - 1) // 32 - i * stride // 32 + 1
             for i in range(8)]
    return n_rows * 32 * sum(spans) / len(spans)


def time_ms(torch, fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` runs, after a warm-up
    run, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"phase 1: built {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s ({_build.nvcc_path()}, "
        f"{' '.join(_build.ARCH_FLAGS)})")
    kernel = None
    for line in _build.build_log().splitlines():
        if line.startswith("=="):
            log(f"  {line.strip()}")
        elif "Compiling entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            log(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def kernel_name(line):
    """``tttp_kernel<3>`` or ``bucket_rows_kernel<16, 1>`` from a ptxas
    line that names a mangled entry function."""
    m = re.search(r"([a-z_]+_kernel)I((?:L[a-z]\d+E)+)E", line)
    if m is None:
        return line.split("'")[1] if "'" in line else line.strip()
    args = re.findall(r"L[a-z](\d+)E", m.group(2))
    return f"{m.group(1)}<{', '.join(args)}>"


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# (shape, nnz, sort_mode): mode-0 rows fill the lower half only, so the upper
# buckets are empty; (400, 30, 20) has about 12 slots per bucket of 8 rows,
# so a warp's slots cross several rows; the tensor sorted by mode 0 gathers
# its mode-0 buckets through a monotone sel, the shuffled ones do not
CHECK_PROBLEMS = (((203, 77, 64), 10000, None), ((41, 30, 20, 12), 9000, None),
                  ((400, 30, 20), 600, None), ((60, 30, 20), 6000, 0))
# 3 and 10 pad to a 16-byte row stride; 160 is wider than one launch of the
# bucketed body (MTTKRP in column tiles, Gram matvec as TTTP + MTTKRP) and
# takes ten of TTTP's 16-column passes over R
CHECK_RANKS = (1, 3, 10, 64, 160)


def _check_problem(torch, gen, shape, nnz, r, dev, sort_mode):
    """A tensor with COO padding whose mode-0 rows fill only the lower half
    (so the upper buckets are empty), in random order or sorted by
    ``sort_mode``, and factors with entries of order 1."""
    from repro_torch.core.sparse_tensor import SparseTensor
    cols = [torch.randint(0, s // 2 if d == 0 else s, (nnz,), generator=gen,
                          device=dev, dtype=torch.int32)
            for d, s in enumerate(shape)]
    vals = torch.rand(nnz, generator=gen, device=dev)
    st = SparseTensor.from_coo(torch.stack(cols, 1), vals, shape,
                               cap=nnz + 37)
    if sort_mode is not None:
        st = st.sort_by_mode(sort_mode)
    factors = [0.5 * torch.randn(s, r, generator=gen, device=dev)
               for s in shape]
    return st, factors


def _layouts(torch, pat, threads):
    """Which of the bucketed kernels' edge cases a bucket pattern holds."""
    nb, c = pat.valid.shape
    key = torch.where(pat.valid, pat.local_row, pat.block_rows)
    seen = {"empty bucket, capacity off the CTA's step":
            bool((pat.valid.sum(1) == 0).any()) and c % threads != 0}
    # a thread takes slots t, t + threads, ...: a run that crosses rows
    # flushes its running sum inside the capacity loop
    full = c // threads * threads
    runs = key[:, :full].reshape(nb, -1, threads)
    seen["thread's run crosses rows"] = bool(
        (runs.amax(1) != runs.amin(1)).any()) if full else False
    # three rows in one warp's 32 slots: flushing lanes hold different rows
    warps = key[:, :c // 32 * 32].reshape(nb, -1, 32)
    rows = torch.arange(pat.block_rows, device=key.device)
    n_rows = (warps[..., None] == rows).any(2).sum(-1)
    seen["warp's slots hold 3 rows"] = bool((n_rows >= 3).any())
    pairs = pat.valid[:, 1:] & pat.valid[:, :-1]
    mono = bool((pat.sel[:, 1:] >= pat.sel[:, :-1])[pairs].all())
    seen["monotone sel" if mono else "shuffled sel"] = True
    return seen


def phase_check(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels import mttkrp as kmttkrp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.sparse.ccsr import bucket_pattern
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_cases = 0
    covered = {}
    worst = {"tttp": 0.0, "mttkrp": 0.0, "cg_matvec": 0.0}

    def close(name, got, want, what):
        nonlocal n_cases
        torch.testing.assert_close(got, want, msg=lambda m: f"{name} {what}: "
                                   f"{m}", **CHECK_TOL)
        worst[name] = max(worst[name], float((got - want).abs().max()))
        n_cases += 1

    def seen(layout, held=True):
        covered[layout] = covered.get(layout, False) or bool(held)

    for shape, nnz, sort_mode in CHECK_PROBLEMS:
        for r in CHECK_RANKS:
            st, factors = _check_problem(torch, gen, shape, nnz, r, dev,
                                         sort_mode)
            what = f"shape={shape} R={r} sorted by {sort_mode}"
            # padding slots holding values: the kernel must read valid
            vals = st.values.clone()
            vals[~st.valid] = 5.0
            raw = dataclasses.replace(st, values=vals)
            for fs, w in ((factors, what),
                          ([None] + factors[1:], what + " factor 0 missing")):
                got = kops.tttp_values(raw, fs)
                close("tttp", got, kref.tttp_ref(vals, st.indices, st.valid,
                                                 fs), w)
                if not bool((got[~st.valid] == 0).all()):
                    raise SystemExit(f"tttp {w}: padding slots not 0")
            seen("tttp: factor missing")
            seen("tttp: padding slots with non-zero values",
                 (~st.valid).any())
            # odd m: no CTA step of any number of nonzeros per thread
            # fills the last one
            seen("tttp: ragged tail", st.cap % 2 == 1)
            omega = st.with_values(torch.ones_like(st.values))
            for block_rows in (8, 16):
                for mode in (0, len(shape) - 1):
                    pat = bucket_pattern(st, mode, block_rows)
                    bk, bo = pat.gather(st), pat.gather(omega)
                    empty = int((bk.valid.sum(1) == 0).sum())
                    w = (f"{what} block_rows={block_rows} mode={mode} "
                         f"capacity={bk.capacity} empty_buckets={empty}")
                    fs = list(factors)
                    fs[mode] = None
                    tiles = len(kmttkrp.column_tiles(r))
                    kops.reset_launch_counts()
                    close("mttkrp",
                          kops.mttkrp_bucketed(bk, fs),
                          kref.mttkrp_bucketed_ref(
                              bk.values, bk.indices, bk.local_row, fs, mode,
                              block_rows)[:shape[mode]], w)
                    x = 0.5 * torch.randn(shape[mode], r, generator=gen,
                                          device=dev)
                    close("cg_matvec",
                          kops.cg_matvec_bucketed(bo, factors, x),
                          kref.cg_matvec_bucketed_ref(
                              bo.values, bo.indices, bo.local_row, factors, x,
                              mode, block_rows)[:shape[mode]], w)
                    # the matvec's TTTP half over the bucket view
                    fx = list(factors)
                    fx[mode] = x
                    nb, c, nd = bo.indices.shape
                    close("tttp", kops.tttp_bucket_values(bo, fx),
                          kref.tttp_ref(bo.values.reshape(-1),
                                        bo.indices.reshape(-1, nd),
                                        bo.valid.reshape(-1), fx).view(nb, c),
                          w + " bucket view")
                    seen("tttp: bucket view")
                    n = kops.launch_counts()
                    wide = r > kmttkrp.MAX_RANK
                    want = {"tttp": 1 + wide, "mttkrp": tiles * (1 + wide),
                            "cg_matvec": int(not wide)}
                    if n != want:
                        raise SystemExit(f"{w}: launches {n}, expected {want}")
                    if wide:
                        seen(f"R={r}: mttkrp in {tiles} column tiles, matvec "
                             f"as tttp + mttkrp")
                    for k, v in _layouts(torch, pat, _build.THREADS).items():
                        seen(k, v)
    torch.cuda.synchronize()
    missing = [k for k, v in covered.items() if not v]
    if missing or len(covered) < 10:
        raise SystemExit(f"phase 2 checks miss layouts: {missing or covered}")
    log(f"phase 2: {n_cases} kernel-vs-plain checks passed at rtol=atol=1e-4 "
        f"(R = {', '.join(map(str, CHECK_RANKS))}; layouts: "
        f"{', '.join(covered)}); max |kernel - plain|: "
        + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def main_argv():
    """The CLI's arguments of the main path's problem."""
    return ["--dataset", "function", "--dims", ",".join(map(str, DIMS)),
            "--nnz", str(NNZ), "--rank", str(RANK), "--cg-iters",
            str(CG_ITERS), "--block-rows", str(BLOCK_ROWS), "--sweeps",
            str(SWEEPS), "--seed", str(SEED), "--device", "cuda"]


def phase_main_path(torch):
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import complete
    argv = ["--algorithm", "als"] + main_argv()
    log(f"phase 3: main path, nnz={NNZ} at dims {DIMS} (no cut)")
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    run = complete.main(argv + ["--matvec-path", "fused"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kops.launch_counts()
    log(f"  fused run: {seconds:.1f} s, launches {launches}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels not launched on the main path: {missing}")
    errs = [run.rmse0] + [e for _, _, e in run.history]
    if not all(math.isfinite(e) for e in errs):
        raise SystemExit(f"RMSE not finite: {errs}")
    if not all(b < a for a, b in zip(errs, errs[1:])):
        raise SystemExit(f"RMSE did not fall: {errs}")
    log(f"  RMSE initial and per sweep: {errs}")
    per_sweep = {k: n / SWEEPS for k, n in launches.items()}
    log(f"  launches per sweep: mttkrp {per_sweep['mttkrp']:.0f} "
        f"(1 per mode), cg_matvec {per_sweep['cg_matvec']:.0f} "
        f"(1 + {CG_ITERS} per mode), tttp {launches['tttp']} in all "
        f"(one RMSE before the sweeps and one after each)")

    args = complete.build_parser().parse_args(
        argv + ["--matvec-path", "tttp_mttkrp"])
    args.sweeps = 1
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    other = complete.run_solver(args, run.dataset, run.init_factors)
    torch.cuda.synchronize()
    other_launches = kops.launch_counts()
    log(f"  tttp_mttkrp run: {time.perf_counter() - t0:.1f} s, sweep "
        f"{other.history[0][1] * 1e3:.1f} ms, launches {other_launches} "
        f"(tttp 1 + {CG_ITERS} per mode in the sweep over the bucket view, "
        f"and one RMSE before and after it; mttkrp 1 + (1 + {CG_ITERS}) per "
        f"mode)")
    if other_launches["tttp"] == 0 or other_launches["mttkrp"] == 0:
        raise SystemExit("tttp_mttkrp route did not launch its kernels")
    for d, (a, b) in enumerate(zip(other.factors, run.sweep_factors[0])):
        scale = float(b.abs().max())
        torch.testing.assert_close(
            a, b, rtol=1e-3, atol=1e-3 * scale,
            msg=lambda m: f"factor {d}, tttp_mttkrp vs fused: {m}")
        log(f"  factor {d}: max |tttp_mttkrp - fused| = "
            f"{float((a - b).abs().max()):.3e} (max |fused| {scale:.3e})")
    return run, launches, other_launches


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def held(torch, name, got, want):
    """Hold a kernel's result at the main path's shapes against its plain
    version: finite, same shape, and within rtol 1e-4 plus an atol of 1e-5
    of the largest plain entry (a bucket row sums thousands of order-1
    terms in an order the shared-memory atomics change). Raises SystemExit
    when it fails; returns max |kernel - plain|."""
    if got.shape != want.shape:
        raise SystemExit(f"phase 4: {name} gave shape {tuple(got.shape)}, its "
                         f"plain version {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"phase 4: {name} gave non-finite values")
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > MAIN_RTOL * want.abs() + MAIN_ATOL_OF_MAX * scale
    if bool(bad.any()):
        raise SystemExit(
            f"phase 4: {name} disagrees with its plain version at the main "
            f"path's shapes: {int(bad.sum())} of {bad.numel()} entries off, "
            f"max |kernel - plain| = {float(err.max()):.3e}, max |plain| = "
            f"{scale:.3e} (rtol {MAIN_RTOL}, atol {MAIN_ATOL_OF_MAX} x max "
            f"|plain|)")
    return float(err.max())


def phase_timing(torch, run, launches, other_launches):
    """Hold each kernel against its plain version on the main path's
    tensors, through the ``kernels.ops`` wrapper the main path calls, then
    time the wrapper, the plain version and the library call."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    st, omega = run.dataset.tensor, run.dataset.omega
    fs = run.factors
    mode = 0
    rows_out = []
    # L2 sector bytes of each kernel's factor-row gathers, from the shapes:
    # printed beside the kernel's time, not part of its JSON row
    gather_bytes = {}

    # TTTP as the RMSE calls it (core.tttp.multilinear_values): unit values,
    # all factors present, Ω's mask read by the kernel
    ones = st.with_values(torch.ones_like(st.values))
    err = held(torch, "tttp", kops.tttp_values(ones, fs),
               kref.tttp_ref(ones.values, ones.indices, ones.valid, fs))
    m, nd = st.indices.shape
    n_valid = int(ones.valid.sum())
    b_ms, b_by = bound(nbytes(ones.values, ones.valid, ones.indices, *fs)
                       + 4 * m, n_valid * RANK * nd)
    rows_out.append(dict(
        name="tttp", route="cuda", source="port/repro_torch/csrc/tttp.cu",
        replaces="src/repro/kernels/tttp.py:61", launches=launches["tttp"],
        max_abs_err=err,
        ms=time_ms(torch, lambda: kops.tttp_values(ones, fs), 20),
        plain_ms=time_ms(torch, lambda: kref.tttp_ref(
            ones.values, ones.indices, ones.valid, fs), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"m={m} nd={nd} R={RANK} valid={n_valid}"))
    gather_bytes["tttp"] = gather_sector_bytes(n_valid * nd, RANK)
    del ones

    # TTTP over Ω's bucket view as the tttp_mttkrp matvec of mode 0 calls it
    # (als.gram_matvec), with x the mode-0 factor as in the fused row below
    bo = omega.row_buckets(mode, BLOCK_ROWS)
    fx = list(fs)
    nb, c, _ = bo.indices.shape

    def plain_tttp_buckets():
        return kref.tttp_ref(bo.values.reshape(-1),
                             bo.indices.reshape(-1, nd), bo.valid.reshape(-1),
                             fx).view(nb, c)

    err = held(torch, "tttp_bucket_view", kops.tttp_bucket_values(bo, fx),
               plain_tttp_buckets())
    n_valid = int(bo.valid.sum())
    b_ms, b_by = bound(nbytes(bo.values, bo.valid, bo.indices, *fx)
                       + 4 * nb * c, n_valid * RANK * nd)
    rows_out.append(dict(
        name="tttp_bucket_view", route="cuda",
        source="port/repro_torch/csrc/tttp.cu",
        replaces="src/repro/kernels/tttp.py:61",
        launches=other_launches["tttp"], max_abs_err=err,
        ms=time_ms(torch, lambda: kops.tttp_bucket_values(bo, fx), 20),
        plain_ms=time_ms(torch, plain_tttp_buckets, 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"nb={nb} C={c} nd={nd} R={RANK} valid={n_valid}"))
    gather_bytes["tttp_bucket_view"] = gather_sector_bytes(n_valid * nd,
                                                           RANK)

    # bucketed MTTKRP as the right-hand side b of mode 0 calls it
    # (core.distributed.mttkrp_ctx)
    bk = st.row_buckets(mode, BLOCK_ROWS)
    rows = st.shape[mode]
    others = list(fs)
    others[mode] = None

    def plain_mttkrp():
        return kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                        others, mode, BLOCK_ROWS)[:rows]

    err = held(torch, "mttkrp_bucketed", kops.mttkrp_bucketed(bk, others),
               plain_mttkrp())
    n_valid = int(bk.valid.sum())
    other_fs = [f for f in others if f is not None]
    out_bytes = 4 * bk.num_blocks * BLOCK_ROWS * RANK
    b_ms, b_by = bound(nbytes(bk.values, bk.indices, bk.local_row, bk.valid,
                              *other_fs) + out_bytes,
                       n_valid * RANK * (len(other_fs) + 1))
    cols = [st.indices[:, d].long() for d in range(nd)]
    mvals = st.masked_values()

    def library_mttkrp():
        prod = mvals[:, None]
        for d, f in enumerate(others):
            if f is not None:
                prod = prod * f[cols[d]]
        return torch.zeros(rows, RANK, device=prod.device
                           ).index_add_(0, cols[mode], prod)

    rows_out.append(dict(
        name="mttkrp_bucketed", route="cuda",
        source="port/repro_torch/csrc/mttkrp.cu",
        replaces="src/repro/kernels/mttkrp.py:83",
        launches=launches["mttkrp"], max_abs_err=err,
        ms=time_ms(torch, lambda: kops.mttkrp_bucketed(bk, others), 20),
        plain_ms=time_ms(torch, plain_mttkrp, 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, library_mttkrp, 3),
        shape=f"nb={bk.num_blocks} C={bk.capacity} block_rows={BLOCK_ROWS} "
              f"R={RANK} valid={n_valid}"))
    gather_bytes["mttkrp_bucketed"] = gather_sector_bytes(
        n_valid * len(other_fs), RANK)
    del bk, cols, mvals

    # fused CG matvec as the CG loop of mode 0 calls it (als.gram_matvec)
    x = fs[mode]

    def plain_cg():
        return kref.cg_matvec_bucketed_ref(bo.values, bo.indices,
                                           bo.local_row, fs, x, mode,
                                           BLOCK_ROWS)[:rows]

    err = held(torch, "cg_matvec_bucketed",
               kops.cg_matvec_bucketed(bo, fs, x), plain_cg())
    n_valid = int(bo.valid.sum())
    b_ms, b_by = bound(nbytes(bo.values, bo.indices, bo.local_row, bo.valid,
                              *other_fs, x) + out_bytes,
                       n_valid * RANK * (len(other_fs) + 3))
    rows_out.append(dict(
        name="cg_matvec_bucketed", route="cuda",
        source="port/repro_torch/csrc/cg_matvec.cu",
        replaces="src/repro/kernels/cg_matvec.py:66",
        launches=launches["cg_matvec"], max_abs_err=err,
        ms=time_ms(torch, lambda: kops.cg_matvec_bucketed(bo, fs, x), 20),
        plain_ms=time_ms(torch, plain_cg, 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"nb={bo.num_blocks} C={bo.capacity} block_rows={BLOCK_ROWS} "
              f"R={RANK} valid={n_valid}"))
    gather_bytes["cg_matvec_bucketed"] = gather_sector_bytes(
        n_valid * len(other_fs), RANK)
    for row in rows_out:
        log(f"phase 4: {row['name']:<18} {row['ms']:9.3f} ms  plain "
            f"{row['plain_ms']:9.3f} ms  bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']})  library {row['library_ms']}  "
            f"max|err| {row['max_abs_err']:.2e}  [{row['shape']}]")
        g = gather_bytes[row["name"]]
        log(f"  factor-row gathers: {g / 1e9:.2f} GB of L2 sectors (from "
            f"shapes), {g / row['ms'] / 1e9:.2f} TB/s")
    log(f"phase 4: each kernel held against its plain version at rtol "
        f"{MAIN_RTOL}, atol {MAIN_ATOL_OF_MAX} x max |plain|")
    return rows_out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def kernel_group(name):
    """Which of the port's kernels a device kernel's name is (the bucketed
    body is bucket_rows_kernel<RMAX, FUSED>, FUSED = true for the matvec)."""
    if "tttp_kernel" in name:
        return "tttp"
    if "bucket_rows_kernel" in name:
        return "cg_matvec" if "true>" in name else "mttkrp"
    return "other"


def profile(torch, label, fn, top=8):
    """Device time of ``fn()`` by kernel, from torch.profiler, the device's
    idle share of its wall time, and the costliest device kernels (the
    port's three and aten's) with their launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): key_averages() would also
    # credit each kernel's time to the aten op that launched it
    by_name, count = {}, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
            count[evt.name] = count.get(evt.name, 0) + 1
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        log(f"{label}: the profiler saw no device time; breakdown not "
            f"measured")
        return
    groups = {"tttp": 0.0, "mttkrp": 0.0, "cg_matvec": 0.0, "other": 0.0}
    launches = {k: 0 for k in groups}
    for name, ms in by_name.items():
        groups[kernel_group(name)] += ms
        launches[kernel_group(name)] += count[name]
    log(f"{label} under torch.profiler: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; device "
        f"ms (launches) by kernel: " +
        ", ".join(f"{k} {v:.1f} ({launches[k]})" for k, v in groups.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:8.2f} ms  {count[name]:4d}x  {name[:110]}")


def phase_profile(torch, run, path):
    """One ALS sweep on matvec route ``path`` under the profiler."""
    from repro_torch.core.completion.als import als_sweep
    st, omega = run.dataset.tensor, run.dataset.omega
    profile(torch, f"phase 5: one {path} sweep",
            lambda: als_sweep(st, omega, run.factors, 1e-5, cg_tol=1e-4,
                              cg_iters=CG_ITERS, matvec_path=path,
                              block_rows=BLOCK_ROWS))


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

# GGN at the reference CLI's defaults (src/repro/launch/complete.py and
# completion/gauss_newton.py): cg_iters 20, 15 joint and 8 preconditioner
# iterations, damping 1e-5; two iterations
GGN_LOSS = "poisson_log"
GGN_ITERATIONS = 2
JOINT_ITERS, PRECOND_ITERS = 15, 8


def solver_args(algorithm, **flags):
    """The CLI's arguments for ``algorithm`` on phase 3's problem."""
    from repro_torch.launch import complete
    argv = main_argv() + ["--algorithm", algorithm]
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return complete.build_parser().parse_args(argv)


def solver_run(torch, label, args, ds, factors):
    """``complete.run_solver`` with every launch count zeroed just before
    and read just after; fails unless the factors are finite."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import complete
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = complete.run_solver(args, ds, factors)
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    if not all(bool(torch.isfinite(f).all()) for f in res.factors):
        raise SystemExit(f"phase 6: {label} gave non-finite factors")
    log(f"  {label}: {time.perf_counter() - t0:.1f} s, sweeps "
        f"{[round(h[1] * 1e3, 1) for h in res.history]} ms, launches "
        f"{launches}")
    return res, launches


def held_close(torch, what, got, want, rtol):
    """``got`` within rtol and an atol of rtol × max |want| of ``want``."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale,
                               msg=lambda m: f"phase 6: {what}: {m}")
    return float((got - want).abs().max()), scale


def phase_solvers(torch, run):
    """The generalized-loss solvers at full width, on phase 3's dataset
    and initial factors (no second ingest). Returns the launch counts of
    each run and the kernel rows of this slice's new shapes."""
    from repro_torch.core import losses
    from repro_torch.core.completion import als, ccd, gauss_newton, sgd
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.sparse.ccsr import bucket_pattern
    ds, init = run.dataset, run.init_factors
    st, omega = ds.tensor, ds.omega
    nd = st.ndim
    counts = {}
    log(f"phase 6: generalized-loss solvers on phase 3's tensor (nnz={NNZ}, "
        f"dims {DIMS}, R={RANK}), from its initial factors")

    # GGN, poisson_log, fused matvec, two iterations
    args = solver_args("ggn", loss=GGN_LOSS, sweeps=GGN_ITERATIONS,
                       matvec_path="fused", damping=1e-5)
    res, counts["ggn"] = solver_run(torch, f"ggn {GGN_LOSS} fused", args, ds,
                                    init)
    obj = res.objective
    if not all(math.isfinite(o) for o in obj):
        raise SystemExit(f"phase 6: GGN objective not finite: {obj}")
    if any(b > a for a, b in zip(obj, obj[1:])) or not obj[-1] < obj[0]:
        raise SystemExit(f"phase 6: GGN objective rose or did not fall: "
                         f"{obj}")
    # per iteration: curvature TTTP, N per joint matvec, f0 and the line
    # search, N curvature TTTPs of the per-mode pass, two accept/reject
    # objectives; the MTTKRP for the gradients, N per joint matvec, and the
    # gradient and diagonal of each mode; the fused matvec (1 + joint) ×
    # N × precond in the preconditioner and N × (1 + cg) in the per-mode pass
    expect = {"tttp": 1 + nd * JOINT_ITERS + 12 + nd + 2,
              "mttkrp": nd + nd * JOINT_ITERS + 2 * nd,
              "cg_matvec": (1 + JOINT_ITERS) * nd * PRECOND_ITERS
              + nd * (1 + CG_ITERS)}
    for i, (h, n) in enumerate(zip(res.history, res.sweep_launches)):
        log(f"  GGN iteration {i}: {h[1] * 1e3:.1f} ms, objective "
            f"{obj[i]:.8g} -> {obj[i + 1]:.8g}, damping {res.damping[i]:.3g}, "
            f"rmse {h[2]:.6f}, launches {n} (expected {expect})")
        if any(v == 0 for v in n.values()):
            raise SystemExit(f"phase 6: GGN iteration {i} did not launch "
                             f"every kernel: {n}")
    ggn_state = gauss_newton.GGNState(
        tuple(res.factors), torch.full((), res.damping[-1], device=st.device))

    # the weighted fused matvec at curvature weights, against its plain
    # version, at the main path's shapes
    w_st, _ = gauss_newton.curvature_tensor(st, init, losses.LOSSES[GGN_LOSS])
    bw = w_st.row_buckets(0, BLOCK_ROWS)
    x = init[0]
    err = held(torch, "cg_matvec_bucketed at curvature weights",
               kops.cg_matvec_bucketed(bw, init, x, num_rows=DIMS[0]),
               kref.cg_matvec_bucketed_ref(bw.values, bw.indices,
                                           bw.local_row, init, x, 0,
                                           BLOCK_ROWS)[:DIMS[0]])
    log(f"  fused matvec at poisson_log curvature weights (max "
        f"{float(w_st.values.max()):.3e}) vs plain: max |err| {err:.2e}")
    del w_st, bw

    # GGN's per-mode pass against ALS: quadratic loss, damping 0, mode 0
    kops.reset_launch_counts()
    g = gauss_newton.ggn_update_mode(st, list(init), 0, losses.quadratic,
                                     1e-5, 0.0, cg_tol=1e-8, cg_iters=40,
                                     matvec_path="fused",
                                     block_rows=BLOCK_ROWS)
    a = als.als_update_mode(st, omega, list(init), 0, 1e-5, cg_tol=1e-8,
                            cg_iters=40, matvec_path="fused",
                            block_rows=BLOCK_ROWS)
    torch.cuda.synchronize()
    counts["ggn_update_mode vs als"] = kops.launch_counts()
    err, scale = held_close(torch, "quadratic ggn_update_mode vs "
                            "als_update_mode", g, a, 2e-3)
    log(f"  quadratic ggn_update_mode vs als_update_mode (mode 0, damping "
        f"0, 40 CG iterations to 1e-8): max |diff| {err:.3e} (max |als| "
        f"{scale:.3e}), launches {counts['ggn_update_mode vs als']}")
    del g, a

    # CCD++, both variants, one sweep each from the same start
    ccd_runs = {}
    for algo in ("ccd", "ccd_tttp"):
        res, counts[algo] = solver_run(torch, algo,
                                       solver_args(algo, sweeps=1),
                                       ds, init)
        errs = [res.rmse0, res.history[0][2]]
        if not all(math.isfinite(e) for e in errs) or not errs[1] < errs[0]:
            raise SystemExit(f"phase 6: {algo} RMSE not finite or did not "
                             f"fall: {errs}")
        log(f"  {algo}: RMSE {errs[0]:.6f} -> {errs[1]:.6f}")
        ccd_runs[algo] = res
    want = 2 * nd * RANK
    if ccd_runs["ccd_tttp"].sweep_launches[0]["tttp"] != want:
        raise SystemExit(f"phase 6: ccd_tttp launched TTTP "
                         f"{ccd_runs['ccd_tttp'].sweep_launches[0]} in its "
                         f"sweep, expected {want} (2 x N x R)")
    for d, (p, q) in enumerate(zip(ccd_runs["ccd_tttp"].factors,
                                   ccd_runs["ccd"].factors)):
        err, scale = held_close(torch, f"ccd_tttp vs ccd factor {d}", p, q,
                                1e-3)
        log(f"  factor {d}: max |ccd_tttp - ccd| {err:.3e} (max |ccd| "
            f"{scale:.3e})")

    # TTTP on vector factors as the CCD++ column update calls it
    cols = [None] + [f[:, 0].contiguous() for f in init[1:]]
    ones = st.with_values(torch.ones_like(st.values))
    vec = [None if c is None else c[:, None] for c in cols]
    err = held(torch, "tttp on vector factors",
               kops.tttp_values(ones, cols),
               kref.tttp_ref(ones.values, ones.indices, ones.valid, vec))
    n_valid = int(ones.valid.sum())
    b_ms, b_by = bound(nbytes(ones.values, ones.valid, ones.indices,
                              *cols[1:]) + 4 * st.cap, n_valid * (nd - 1))
    rows = [dict(
        name="tttp_vector", route="cuda",
        source="port/repro_torch/csrc/tttp.cu",
        replaces="src/repro/kernels/tttp.py:61",
        launches=counts["ccd_tttp"]["tttp"], max_abs_err=err,
        ms=time_ms(torch, lambda: kops.tttp_values(ones, cols), 20),
        plain_ms=time_ms(torch, lambda: kref.tttp_ref(
            ones.values, ones.indices, ones.valid, vec), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"m={st.cap} nd={nd} R=1 (factor 0 missing) valid={n_valid}")]
    del ones

    # GCP, poisson_log, Adam, one step; SGD at sample rate 0.1, one sweep
    res, counts["gcp"] = solver_run(
        torch, f"gcp {GGN_LOSS} adam lr 1e-3",
        solver_args("gcp", loss=GGN_LOSS, lr=1e-3, sweeps=1), ds,
        init)
    log(f"  gcp objective {res.objective[0]:.8g} -> {res.objective[1]:.8g}")
    args = solver_args("sgd", sample_rate=0.1, sweeps=1)
    res, counts["sgd"] = solver_run(torch, "sgd sample rate 0.1", args, ds,
                                    init)
    for name, n in (("gcp", counts["gcp"]), ("sgd", counts["sgd"])):
        if n["tttp"] == 0 or n["mttkrp"] == 0:
            raise SystemExit(f"phase 6: {name} did not launch TTTP and the "
                             f"MTTKRP: {n}")
    # what a new sample's bucket patterns cost, against the sweep
    gen = torch.Generator(device=st.device).manual_seed(SEED + 1)
    size = max(1024, int(0.1 * st.nnz))
    sample = sgd.sample_entries(gen, st, size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pats = [bucket_pattern(sample, d, BLOCK_ROWS) for d in range(nd)]
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    sweep_ms = res.history[0][1] * 1e3
    log(f"  sgd: {nd} bucket-pattern builds of a {size}-entry sample take "
        f"{build_ms:.1f} ms, {build_ms / sweep_ms:.1%} of the "
        f"{sweep_ms:.1f} ms sweep")
    # the MTTKRP on a sample's bucket view, against its plain version
    sample.attach_pattern(0, BLOCK_ROWS, pats[0])
    bk = sample.row_buckets(0, BLOCK_ROWS)
    others = [None] + list(init[1:])
    err = held(torch, "mttkrp_bucketed on an SGD sample",
               kops.mttkrp_bucketed(bk, others, num_rows=DIMS[0]),
               kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                        others, 0, BLOCK_ROWS)[:DIMS[0]])
    log(f"  mttkrp on the sample's bucket view (C={bk.capacity}) vs plain: "
        f"max |err| {err:.2e}")
    del sample, pats, bk

    # one GGN iteration under the profiler
    profile(torch, "phase 6: one GGN iteration (poisson_log, fused)",
            lambda: gauss_newton.ggn_sweep(
                st, ggn_state, losses.LOSSES[GGN_LOSS], 1e-5, cg_iters=CG_ITERS,
                joint_iters=JOINT_ITERS, precond_iters=PRECOND_ITERS,
                matvec_path="fused", block_rows=BLOCK_ROWS), top=12)
    log(f"phase 6: passed; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return counts, rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops  # noqa: F401 (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 off")
    phase_build()
    phase_check(torch, dev)
    run, launches, other_launches = phase_main_path(torch)
    kernels = phase_timing(torch, run, launches, other_launches)
    for path in ("fused", "tttp_mttkrp"):
        phase_profile(torch, run, path)
    solver_counts, solver_rows = phase_solvers(torch, run)
    kernels += solver_rows
    # phase 7: each kernel's launches in every run of phases 3 and 6, each
    # counted from zero
    paths = {"als fused": launches, "als tttp_mttkrp": other_launches,
             **solver_counts}
    for row in kernels:
        group = "tttp" if row["name"].startswith("tttp") else \
            row["name"].replace("_bucketed", "")
        row["path_launches"] = {p: n[group] for p, n in paths.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
