#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``port/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout this file sits in. It runs
six phases and stops with a non-zero exit at the first failure:

1. build the CUDA kernels from ``port/repro_torch/csrc`` with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on the card: R = 3,
   10 and 64 (3 and 10 padded to a 16-byte row stride), block_rows 8 and
   16, orders 3 and 4, empty buckets, padding slots, a bucket capacity that
   is not a multiple of the CTA's step, threads whose slots cross rows (the
   running sums flush inside the capacity loop), warps whose slots hold
   three rows, tensors sorted and not sorted by the bucketed mode (monotone
   and shuffled ``sel``), a missing factor; the run fails unless every one
   of these layouts occurred; rtol = atol = 1e-4 (shared-memory atomics
   change the order of the bucket sums from run to run);
3. run implicit-CG ALS through ``repro_torch.launch.complete``: the function
   tensor at dims 20000^3 with 80 M nonzeros (density 1e-5, paper Fig. 7a),
   rank 10, 20 CG iterations, block_rows 8, two sweeps on the fused matvec,
   with every kernel's launch count zeroed before and read after; RMSE must
   be finite and fall, and each kernel must have launched. Then one sweep on
   the TTTP + bucketed-MTTKRP matvec from the same start, whose factors must
   match the fused run's first sweep at rtol 1e-3 (atol 1e-3 of the
   factor's largest entry): CG carries the two routes' different summation
   orders through 20 iterations and three modes;
4. hold each kernel, through the ``kernels.ops`` wrapper the main path
   calls, against its plain version on the main path's tensors (rtol 1e-4,
   atol 1e-5 of the largest plain entry; a disagreement fails the run),
   then time each with CUDA events at those shapes (the bucketed wrappers'
   time includes their padded copies of the factors and x), beside its
   plain version, the one PyTorch call that computes the same function
   where there is one, and the least time the card could take (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger); for
   the bucketed kernels also the L2 sector bytes of their factor-row
   gathers, computed from the shapes, and the rate that implies;
5. profile one fused sweep with torch.profiler: device time by kernel, the
   device's idle share of the sweep, and the costliest device kernels with
   their launch counts (the bucket values were gathered in phase 3, once
   per tensor and mode, so no gather of them shows here);
6. print the kernel table as one JSON line, the card's name and power limit,
   and, last, ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
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
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# (shape, nnz, sort_mode): mode-0 rows fill the lower half only, so the upper
# buckets are empty; (400, 30, 20) has about 12 slots per bucket of 8 rows,
# so a warp's slots cross several rows; the tensor sorted by mode 0 gathers
# its mode-0 buckets through a monotone sel, the shuffled ones do not
CHECK_PROBLEMS = (((203, 77, 64), 10000, None), ((41, 30, 20, 12), 9000, None),
                  ((400, 30, 20), 600, None), ((60, 30, 20), 6000, 0))


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

    for shape, nnz, sort_mode in CHECK_PROBLEMS:
        for r in (3, 10, 64):
            st, factors = _check_problem(torch, gen, shape, nnz, r, dev,
                                         sort_mode)
            vals = st.values * st.mask
            what = f"shape={shape} R={r} sorted by {sort_mode}"
            close("tttp", kops.tttp_values(st, factors),
                  kref.tttp_ref(vals, st.indices, factors), what)
            partial = [None] + factors[1:]
            close("tttp", kops.tttp_values(st, partial),
                  kref.tttp_ref(vals, st.indices, partial),
                  what + " factor 0 missing")
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
                    for k, v in _layouts(torch, pat, _build.THREADS).items():
                        covered[k] = covered.get(k, False) or v
    torch.cuda.synchronize()
    missing = [k for k, v in covered.items() if not v]
    if missing or len(covered) < 5:
        raise SystemExit(f"phase 2 checks miss layouts: {missing or covered}")
    log(f"phase 2: {n_cases} kernel-vs-plain checks passed at rtol=atol=1e-4 "
        f"(R = 3, 10, 64; layouts: {', '.join(covered)}); max |kernel - "
        f"plain|: " + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_main_path(torch):
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import complete
    argv = ["--algorithm", "als", "--dataset", "function",
            "--dims", ",".join(map(str, DIMS)), "--nnz", str(NNZ),
            "--rank", str(RANK), "--cg-iters", str(CG_ITERS),
            "--block-rows", str(BLOCK_ROWS), "--sweeps", str(SWEEPS),
            "--seed", str(SEED), "--device", "cuda"]
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
    other = complete.run_als(args, run.dataset, run.init_factors)
    torch.cuda.synchronize()
    other_launches = kops.launch_counts()
    log(f"  tttp_mttkrp sweep: {time.perf_counter() - t0:.1f} s, launches "
        f"{other_launches}")
    if other_launches["tttp"] == 0 or other_launches["mttkrp"] == 0:
        raise SystemExit("tttp_mttkrp route did not launch its kernels")
    for d, (a, b) in enumerate(zip(other.factors, run.sweep_factors[0])):
        scale = float(b.abs().max())
        torch.testing.assert_close(
            a, b, rtol=1e-3, atol=1e-3 * scale,
            msg=lambda m: f"factor {d}, tttp_mttkrp vs fused: {m}")
        log(f"  factor {d}: max |tttp_mttkrp - fused| = "
            f"{float((a - b).abs().max()):.3e} (max |fused| {scale:.3e})")
    return run, launches


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


def phase_timing(torch, run, launches):
    """Hold each kernel against its plain version on the main path's
    tensors, through the ``kernels.ops`` wrapper the main path calls, then
    time the wrapper, the plain version and the library call."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    st, omega = run.dataset.tensor, run.dataset.omega
    fs = run.factors
    mode = 0
    rows_out = []
    # L2 sector bytes of each bucketed kernel's factor-row gathers, from the
    # shapes: printed beside the kernel's time, not part of its JSON row
    gather_bytes = {}

    # TTTP as the RMSE calls it (core.tttp.multilinear_values): unit values
    # masked by Ω, all factors present
    ones = st.with_values(torch.ones_like(st.values))
    err = held(torch, "tttp", kops.tttp_values(ones, fs),
               kref.tttp_ref(ones.values * ones.mask, ones.indices, fs))
    m, nd = st.indices.shape
    b_ms, b_by = bound(nbytes(ones.values, ones.mask, ones.indices, *fs)
                       + 4 * m, m * RANK * nd)
    rows_out.append(dict(
        name="tttp", route="cuda", source="port/repro_torch/csrc/tttp.cu",
        replaces="src/repro/kernels/tttp.py:61", launches=launches["tttp"],
        max_abs_err=err,
        ms=time_ms(torch, lambda: kops.tttp_values(ones, fs), 20),
        plain_ms=time_ms(torch, lambda: kref.tttp_ref(
            ones.values * ones.mask, ones.indices, fs), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"m={m} nd={nd} R={RANK}"))
    del ones

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
    bo = omega.row_buckets(mode, BLOCK_ROWS)
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
        if row["name"] in gather_bytes:
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


def phase_profile(torch, run):
    """Device time of one fused sweep by kernel, from torch.profiler, and the
    device's idle share of the sweep's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.completion.als import als_sweep
    st, omega = run.dataset.tensor, run.dataset.omega
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        als_sweep(st, omega, run.factors, 1e-5, cg_tol=1e-4,
                  cg_iters=CG_ITERS, matvec_path="fused",
                  block_rows=BLOCK_ROWS)
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
        log("phase 5: the profiler saw no device time; breakdown not "
            "measured")
        return
    groups = {"tttp": 0.0, "mttkrp": 0.0, "cg_matvec": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        groups[kernel_group(name)] += ms
    log(f"phase 5: one fused sweep under torch.profiler: wall {wall_ms:.1f} "
        f"ms, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; device ms by kernel: " +
        ", ".join(f"{k} {v:.1f}" for k, v in groups.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:8.2f} ms  {count[name]:4d}x  {name[:110]}")


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
    run, launches = phase_main_path(torch)
    kernels = phase_timing(torch, run, launches)
    phase_profile(torch, run)
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
