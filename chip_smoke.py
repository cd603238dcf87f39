#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``port/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout this file sits in. It runs
ten phases and stops with a non-zero exit at the first failure (9a-9d run
right after phase 6, on phase 3's tensor before it is freed, 9e after
phase 8, on 7e's factors):

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
7. free phase 3's dataset, then drive the streamed path:
   a. stream the function tensor (80 M entries at dims 20000^3, chunks of
      2^22, 10 % held out) through ``CompletionDataset.from_stream`` onto
      the card; print the ingest's wall and busy seconds, Mnnz/s and peak
      RSS, the entries read, duplicates dropped and train/test nnz, and per
      mode the capacity from the streamed counts, the true maximum
      occupancy and the slots per nonzero; fail unless every capacity holds
      its fullest bucket, train + test + duplicates = entries read, and the
      train and test coordinates are disjoint; hold TTTP, the MTTKRP and
      the fused matvec on the streamed (sorted) mode-0 layout against their
      plain versions;
   b. ``launch.experiment.run_on_dataset`` (``run_experiment`` on a dataset
      already ingested) on that dataset: rank 10, 3 sweeps, (als, ccd, sgd,
      ggn) x (quadratic, poisson_log); fail unless every objective and
      held-out metric is finite, the objectives of als, ccd and ggn never
      rise by more than 1e-5 of their first value, every run launched TTTP,
      every run but ccd (which reduces with ``index_add_``, as the
      reference's with a segment sum) the MTTKRP, als and ggn the fused
      matvec, and the report JSON reads back with the reference's keys;
   c. ALS on that dataset through ``RestartableLoop`` (6 sweeps, a
      checkpoint every 5) with a failure injected after sweep 5: exactly
      that RuntimeError, then a new loop resumes from the checkpoint of
      sweep 4, runs one sweep (its launch counts show it) and matches an
      uninterrupted run at rtol 1e-4, atol 1e-5 of the largest entry;
   d. the reference's ``netflix-small`` spec through ``run_experiment`` on
      the card (the checks of b), then the MTTKRP and the fused matvec on
      its Zipf-skewed mode-0 buckets against their plain versions, the
      slots per nonzero of each mode, and the fused matvec timed beside its
      bound;
   e. ``launch.complete --dump-factors DIR`` (ALS at dims 2000,1500,1000),
      restored by the port's checkpointer onto the card from the metadata
      it wrote;
   then print the peak device memory of phase 7;
8. drive the serving path (``repro_torch.serve``), each run with the launch
   counts zeroed before and read after:
   a. ``launch.serve_complete --verify`` on 7e's factors: 100 000 queries
      at batch 1024, top-10, 32 cold users folded in; fails on a non-zero
      exit or without ``verify OK``, or unless all three kernels launched;
   b. the paper-netflix extents and rank (480 189 x 17 770 x 2 182, R =
      32; factors from the seed, N(0, 1/R), written by the checkpointer
      with the dump metadata and restored by ``load_factors``) through the
      engine's CUDA graphs: 1 048 576 scored queries in batches of 1024
      (QPS and per-batch p50/p95/p99), top-10 over movies for 1024 queries
      and over users for 64 (118 blocks of 4096 rows), and 1024 cold users
      x 200 ratings folded in (128 buckets of 8 users); each first
      (capturing) call timed apart from the replays; every output finite
      and within the ``--verify`` limits of a float64 host oracle (scores
      and top-k 1e-6 x max(1, max|s|), fold-in rows 1e-4); one TTTP per
      score call and one MTTKRP and 1 + 128 fused matvecs per fold-in call,
      counted through the replays; then TTTP at the score batch and the
      MTTKRP and the fused matvec (``bucket_rows_kernel<32, ...>``) at the
      fold-in layout, each held against its plain version (phase 4's
      tolerance) and timed beside its bound (the bytes of the entries and
      of the distinct factor rows they gather); print phase 8's peak
      device memory;
9. drive the planner (``repro_torch.planner``, the ``ctf`` facade), each
   run with the launch counts zeroed before and read after:
   a. one ALS sweep each with ``--matvec-path auto`` and ``sliced`` from
      phase 3's initial factors: auto must launch what a fused sweep does
      (3 MTTKRPs and 63 fused matvecs, 2 RMSE TTTPs) and match phase 3's
      first fused sweep at rtol 1e-4 (atol 1e-4 of the largest entry);
      sliced (H = 2 at R = 10) 2 TTTPs and 2 MTTKRPs per matvec, at rtol
      1e-3 as phase 3's ``tttp_mttkrp`` sweep;
   b. for classic MTTKRP, TTTP, the Gram matvec and the mode reduction on
      phase 3's tensor, every candidate whose estimated memory traffic is
      at most 2^32 words (16 GiB, the card's memory sets the cut) forced
      through ``ctf.einsum(path=)``, held at phase 4's tolerance against
      a plain result on the same inputs (MTTKRP: ``sparse.ops.mttkrp``;
      the reduction: ``index_add_`` of the masked values) or, for TTTP and
      the Gram matvec, against the default path (phase 4 holds their
      kernels against plain versions), and timed by CUDA events beside
      the cost model's predicted time; each forced call's ``PlanRecord`` (predicted beside
      fenced wall time) printed;
   c. the same at 7e's dims (2000 x 1500 x 1000, 2 M nonzeros), where the
      dense, KR-first and T-first candidates fit, plus TTM; then the rates
      ``cost.calibrate`` fits to the 9b and 9c samples, printed and not
      installed;
   d. one ``autotune=True`` plan of the Gram matvec at phase 3's size: its
      fenced timings and winner;
   e. ``launch.serve_complete --score-path all_at_once --matvec-path
      sliced --verify`` on 7e's factors: ``verify OK``, TTTP and the
      MTTKRP launched, no fused matvec;
10. print the kernel table as one JSON line (each row with its launches in
   the main path's run, and in every run of phases 3, 6, 7, 8 and 9 under
   ``path_launches``), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


def graph_ms(torch, fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls captured in one
    CUDA graph, by CUDA events around its replay: the device's time for
    the work, without the host's time to enqueue it (which the serving
    engine's replays do not pay either). The launches the capture records
    are taken back out of the counts."""
    from repro_torch.kernels import ops as kops
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kops.recorded_launches():
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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

def held(torch, name, got, want, where="phase 4"):
    """Hold a kernel's result at the main path's shapes against its plain
    version: finite, same shape, and within rtol 1e-4 plus an atol of 1e-5
    of the largest plain entry (a bucket row sums thousands of order-1
    terms in an order the shared-memory atomics change). Raises SystemExit
    when it fails; returns max |kernel - plain|."""
    if got.shape != want.shape:
        raise SystemExit(f"{where}: {name} gave shape {tuple(got.shape)}, its "
                         f"plain version {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"{where}: {name} gave non-finite values")
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > MAIN_RTOL * want.abs() + MAIN_ATOL_OF_MAX * scale
    if bool(bad.any()):
        raise SystemExit(
            f"{where}: {name} disagrees with its plain version: "
            f"{int(bad.sum())} of {bad.numel()} entries off, "
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


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

# 7a/7b: the function stream at the main path's size, 10 % held out
STREAM_CHUNK = 1 << 22
TEST_FRACTION = 0.1
EXP_SWEEPS = 3
# the JAX package's experiment report keys (src/repro/launch/experiment.py)
REPORT_KEYS = {"spec", "ingest", "runs"}
INGEST_KEYS = {"seconds", "nnz", "test_nnz", "chunks", "entries_read",
               "duplicates_dropped", "nnz_rows", "shard_nnz", "busy_seconds",
               "mnnz_per_s", "spills", "peak_rss_mb"}
RUN_KEYS = {"algorithm", "loss", "update_loss", "link", "rank",
            "total_seconds", "sweeps", "final"}
SWEEP_KEYS = {"sweep", "seconds", "objective", "rmse_train", "rmse_test",
              "poisson_deviance_test"}
# the reference CLI's --dump-factors DIR metadata (src/repro/launch/complete.py)
DUMP_KEYS = {"kind", "rank", "shape", "algorithm", "loss", "link", "dataset",
             "nnz", "sweeps"}


def phase_stream(torch):
    """7a: the function tensor streamed through ``from_stream`` onto the
    card. Returns the dataset and the ingest's wall seconds."""
    import numpy as np
    from repro_torch.data import streaming
    from repro_torch.data.pipeline import CompletionDataset
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.sparse.ccsr import bucket_capacity
    log(f"phase 7a: streamed ingest of the function tensor, nnz={NNZ} at "
        f"dims {DIMS}, chunks of {STREAM_CHUNK}, {TEST_FRACTION:.0%} held "
        f"out, block_rows {BLOCK_ROWS}")
    t0 = time.perf_counter()
    ds = CompletionDataset.from_stream(
        streaming.make_stream("function", SEED, DIMS, NNZ, STREAM_CHUNK),
        DIMS, test_fraction=TEST_FRACTION, block_rows=BLOCK_ROWS,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, te, stats = ds.tensor, ds.test, ds.stats
    if st.device.type != "cuda" or te.device.type != "cuda":
        raise SystemExit(f"phase 7a: dataset not on the card: {st.device}, "
                         f"{te.device}")
    tstats = stats.test_stats
    read = stats.entries_read + tstats.entries_read
    dups = stats.duplicates_dropped + tstats.duplicates_dropped
    busy = stats.ingest_seconds + tstats.ingest_seconds
    log(f"  ingest wall {wall:.1f} s, busy {busy:.1f} s (train "
        f"{stats.ingest_seconds:.1f}, test {tstats.ingest_seconds:.1f}), "
        f"{read / busy / 1e6:.2f} Mnnz/s over busy time, "
        f"{read / wall / 1e6:.2f} over wall, peak RSS "
        f"{max(stats.peak_rss_mb, tstats.peak_rss_mb):.0f} MB")
    log(f"  entries read {read} ({stats.chunks} chunks), duplicates dropped "
        f"{dups} (train {stats.duplicates_dropped}, test "
        f"{tstats.duplicates_dropped}), train nnz {st.nnz}, test nnz "
        f"{te.nnz}")
    if read != NNZ or st.nnz + te.nnz + dups != read:
        raise SystemExit(f"phase 7a: train {st.nnz} + test {te.nnz} + "
                         f"duplicates {dups} != entries read {read} "
                         f"(stream of {NNZ})")
    for mode in range(st.ndim):
        pat = st._pattern_cache[(mode, BLOCK_ROWS)]
        nb, cap = pat.sel.shape
        most = int(pat.valid.sum(1).max())
        streamed = bucket_capacity(stats.bucket_counts[mode])
        log(f"  mode {mode}: capacity {cap} (streamed counts give "
            f"{streamed}), true max occupancy {most}, {nb} buckets, "
            f"{nb * cap / st.nnz:.3f} slots per nonzero")
        if cap != streamed or cap < most:
            raise SystemExit(f"phase 7a: mode {mode} capacity {cap} (streamed "
                             f"{streamed}) below its true max {most}")
    lin = []
    for t in (st, te):
        idx = t.indices[t.valid].cpu().numpy().astype(np.int64)
        lin.append((idx[:, 0] * DIMS[1] + idx[:, 1]) * DIMS[2] + idx[:, 2])
    both = np.intersect1d(lin[0], lin[1], assume_unique=True)
    if both.size:
        raise SystemExit(f"phase 7a: {both.size} coordinates in both the "
                         f"train and the test tensor")
    log("  train and test coordinate sets disjoint (np.intersect1d)")
    del lin, both
    # the kernels on the streamed layout: mode 0's sel is monotone
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fs = [torch.randn(d, RANK, generator=gen, device="cuda") / RANK ** 0.5
          for d in DIMS]
    ones = st.with_values(torch.ones_like(st.values))
    err_t = held(torch, "tttp on the streamed tensor",
                 kops.tttp_values(ones, fs),
                 kref.tttp_ref(ones.values, ones.indices, ones.valid, fs),
                 "phase 7a")
    bo = ds.omega.row_buckets(0, BLOCK_ROWS)
    bk = st.row_buckets(0, BLOCK_ROWS)
    others = [None] + fs[1:]
    err_m = held(torch, "mttkrp_bucketed on the streamed tensor",
                 kops.mttkrp_bucketed(bk, others),
                 kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                          others, 0, BLOCK_ROWS)[:DIMS[0]],
                 "phase 7a")
    err_c = held(torch, "cg_matvec_bucketed on the streamed tensor",
                 kops.cg_matvec_bucketed(bo, fs, fs[0]),
                 kref.cg_matvec_bucketed_ref(bo.values, bo.indices,
                                             bo.local_row, fs, fs[0], 0,
                                             BLOCK_ROWS)[:DIMS[0]],
                 "phase 7a")
    log(f"  kernels vs plain on the streamed mode-0 layout: max |err| tttp "
        f"{err_t:.2e}, mttkrp {err_m:.2e}, cg_matvec {err_c:.2e}")
    return ds, wall


def check_report(torch, label, report, path, diverges=()):
    """The report written to ``path`` reads back with the reference's keys;
    every objective and held-out metric is finite but those of the
    algorithms in ``diverges``; the objectives of als, ccd and ggn never
    rise by more than 1e-5 of their first value; every
    run launched TTTP, every run but ccd (its einsum variant reduces with
    ``index_add_``, as the reference's with a segment sum) the MTTKRP, and
    als and ggn the fused matvec. Returns each run's launches."""
    with open(path) as f:
        back = json.load(f)
    if back != json.loads(json.dumps(report)):
        raise SystemExit(f"{label}: {path} does not read back as the report")
    if not REPORT_KEYS <= set(back) or set(back["ingest"]) != INGEST_KEYS:
        raise SystemExit(f"{label}: report keys {sorted(back)} / "
                         f"{sorted(back['ingest'])}")
    launches = {}
    for run in back["runs"]:
        name = f"{run['algorithm']}/{run['loss']}"
        if not RUN_KEYS <= set(run) or \
                any(set(e) != SWEEP_KEYS for e in run["sweeps"]):
            raise SystemExit(f"{label}: {name} keys {sorted(run)}")
        obj = [e["objective"] for e in run["sweeps"]]
        finite = [e[k] for e in run["sweeps"]
                  for k in ("objective", "rmse_test", "poisson_deviance_test")]
        if run["algorithm"] not in diverges and \
                not all(math.isfinite(v) for v in finite):
            raise SystemExit(f"{label}: {name} metrics not finite: "
                             f"{run['sweeps']}")
        if run["algorithm"] in ("als", "ccd", "ggn") and any(
                b - a > 1e-5 * abs(obj[0]) for a, b in zip(obj, obj[1:])):
            raise SystemExit(f"{label}: {name} objective rose: {obj}")
        n = run["launches"]
        need = ["tttp"] + (["mttkrp"] if run["algorithm"] != "ccd" else []) \
            + (["cg_matvec"] if run["algorithm"] in ("als", "ggn") else [])
        if any(n[k] == 0 for k in need):
            raise SystemExit(f"{label}: {name} did not launch {need}: {n}")
        fin = run["final"]
        ms = sum(e["seconds"] for e in run["sweeps"]) / len(run["sweeps"])
        log(f"  {name}: mean sweep {ms * 1e3:.1f} ms, objective "
            f"{obj[0]:.7g} -> {obj[-1]:.7g}, final rmse_test "
            f"{fin['rmse_test']:.6f}, poisson_deviance_test "
            f"{fin['poisson_deviance_test']:.6f}, launches {n}")
        launches[name] = n
    return launches


def phase_experiment(torch, ds, ingest_seconds, tmp):
    """7b: the experiment harness at full width on 7a's dataset."""
    from repro_torch.launch import experiment
    spec = experiment.ExperimentSpec(
        "chip-function", "function", DIMS, NNZ, STREAM_CHUNK, rank=RANK,
        sweeps=EXP_SWEEPS, test_fraction=TEST_FRACTION, seed=SEED,
        note="chip_smoke.py phase 7: the main path's tensor, streamed")
    log(f"phase 7b: run_on_dataset on 7a's dataset: {spec.algorithms} x "
        f"{spec.losses}, rank {RANK}, {EXP_SWEEPS} sweeps, lam {spec.lam}")
    out = os.path.join(tmp, "experiments")
    report = experiment.run_on_dataset(spec, ds, ingest_seconds, out_dir=out,
                                       ckpt_root=os.path.join(tmp, "ckpt"))
    torch.cuda.synchronize()
    launches = check_report(torch, "phase 7b", report, os.path.join(
        out, f"experiment_{spec.name}.json"))
    if len(launches) != len(spec.algorithms) * len(spec.losses):
        raise SystemExit(f"phase 7b: runs {sorted(launches)}")
    return spec, {f"exp {k}": v for k, v in launches.items()}


def phase_restart(torch, ds, spec, tmp):
    """7c: ALS through RestartableLoop, killed after sweep 5, resumed from
    the checkpoint of sweep 4, against an uninterrupted run."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import experiment
    from repro_torch.runtime import RestartableLoop
    sweeps, every, fail_at = 6, 5, 5
    fs = experiment.initial_factors(spec, "als", "quadratic", "cuda")
    state0, step, get, _, _ = experiment.make_solver(
        "als", "quadratic", ds.tensor, ds.omega, fs, spec, ds.block_rows)
    log(f"phase 7c: ALS on 7a's dataset through RestartableLoop, {sweeps} "
        f"sweeps, ckpt_every {every}, failure injected after sweep {fail_at}")
    whole = RestartableLoop(os.path.join(tmp, "whole"), step,
                            ckpt_every=every).run(state0, sweeps)
    cut = os.path.join(tmp, "cut")
    raised = None
    try:
        RestartableLoop(cut, step, ckpt_every=every).run(state0, sweeps,
                                                         fail_at=fail_at)
    except RuntimeError as e:
        if str(e) != f"injected failure at step {fail_at}":
            raise
        raised = e
    if raised is None:
        raise SystemExit("phase 7c: the injected failure was not raised")
    if latest_step(cut) != every - 1:
        raise SystemExit(f"phase 7c: newest checkpoint {latest_step(cut)}, "
                         f"expected {every - 1}")
    ran = []

    def counted(i, state):
        ran.append(i)
        return step(i, state)

    kops.reset_launch_counts()
    got = RestartableLoop(cut, counted, ckpt_every=every).run(state0, sweeps)
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    want = {"tttp": 0, "mttkrp": len(DIMS),
            "cg_matvec": len(DIMS) * (1 + spec.cg_iters)}
    log(f"  raised {raised!r}; resumed from step {every - 1}, ran sweeps "
        f"{ran}, launches {launches} (one sweep: {want})")
    if ran != [every] or launches != want:
        raise SystemExit(f"phase 7c: the resumed loop ran {ran} with "
                         f"launches {launches}, expected [{every}] and {want}")
    for d, (a, b) in enumerate(zip(get(got), get(whole))):
        scale = float(b.abs().max())
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * scale,
            msg=lambda m: f"phase 7c: factor {d}, resumed vs whole: {m}")
        log(f"  factor {d}: max |resumed - whole| "
            f"{float((a - b).abs().max()):.3e} (max |whole| {scale:.3e})")
    return {"restart resume": launches}


def phase_skewed(torch, tmp):
    """7d: the reference's netflix-small spec through run_experiment on the
    card, then the fused matvec and the MTTKRP on its skewed mode-0 buckets
    against their plain versions, and the fused matvec timed."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import experiment
    spec = experiment.SPECS["netflix-small"]
    log(f"phase 7d: run_experiment('{spec.name}') on cuda: shape "
        f"{spec.shape}, {spec.nnz} entries, rank {spec.rank}, {spec.sweeps} "
        f"sweeps, {spec.algorithms} x {spec.losses}")
    out = os.path.join(tmp, "netflix")
    report = experiment.run_experiment(spec, out_dir=out,
                                       ckpt_root=os.path.join(out, "ckpt"),
                                       device="cuda")
    torch.cuda.synchronize()
    # SGD at the spec's lr 1e-3 overflows on these ratings by its fifth
    # sweep in the JAX package too (counts of 1..5 summed over popular rows)
    launches = check_report(torch, "phase 7d", report, os.path.join(
        out, f"experiment_{spec.name}.json"), diverges=("sgd",))
    ds, _ = experiment.ingest_spec(spec, device="cuda")
    st = ds.tensor
    for mode in range(st.ndim):
        pat = st._pattern_cache[(mode, ds.block_rows)]
        nb, cap = pat.sel.shape
        occ = pat.valid.sum(1)
        log(f"  mode {mode}: {nb} buckets x capacity {cap}, occupancy max "
            f"{int(occ.max())} / mean {float(occ.float().mean()):.0f}: "
            f"{nb * cap / st.nnz:.2f} slots per nonzero (nnz {st.nnz})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = spec.rank
    fs = [torch.randn(d, r, generator=gen, device="cuda") / r ** 0.5
          for d in spec.shape]
    rows = spec.shape[0]
    bo = ds.omega.row_buckets(0, ds.block_rows)
    bk = st.row_buckets(0, ds.block_rows)
    others = [None] + fs[1:]
    err_m = held(torch, "mttkrp_bucketed on skewed buckets",
                 kops.mttkrp_bucketed(bk, others),
                 kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                          others, 0, ds.block_rows)[:rows],
                 "phase 7d")
    x = fs[0]

    def plain_cg():
        return kref.cg_matvec_bucketed_ref(bo.values, bo.indices,
                                           bo.local_row, fs, x, 0,
                                           ds.block_rows)[:rows]

    err = held(torch, "cg_matvec_bucketed on skewed buckets",
               kops.cg_matvec_bucketed(bo, fs, x), plain_cg(), "phase 7d")
    n_valid = int(bo.valid.sum())
    # The function needs only the valid entries: count their bytes, not the
    # padded slots (about 11 per entry here, the skew cost this row shows)
    slot_bytes = sum(t[0, 0].numel() * t.element_size()
                     for t in (bo.values, bo.indices, bo.local_row, bo.valid))
    out_bytes = 4 * bo.num_blocks * ds.block_rows * r
    b_ms, b_by = bound(n_valid * slot_bytes + nbytes(*fs[1:], x) + out_bytes,
                       n_valid * r * (len(fs) + 2))
    log(f"  skewed mode 0: {n_valid} valid entries x {slot_bytes} B; the "
        f"{bo.num_blocks * bo.capacity} padded slots hold "
        f"{bo.num_blocks * bo.capacity * slot_bytes} B")
    row = dict(
        name="cg_matvec_skewed", route="cuda",
        source="port/repro_torch/csrc/cg_matvec.cu",
        replaces="src/repro/kernels/cg_matvec.py:66",
        launches=sum(n["cg_matvec"] for n in launches.values()),
        max_abs_err=err,
        ms=time_ms(torch, lambda: kops.cg_matvec_bucketed(bo, fs, x), 50),
        plain_ms=time_ms(torch, plain_cg, 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"netflix-small mode 0: nb={bo.num_blocks} C={bo.capacity} "
              f"block_rows={ds.block_rows} R={r} valid={n_valid}")
    log(f"  mttkrp vs plain max |err| {err_m:.2e}; fused matvec "
        f"{row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, bound "
        f"{b_ms:.4f} ms by {b_by}), max |err| {err:.2e}, launches in the "
        f"netflix-small runs {row['launches']}")
    return {f"netflix-small {k}": v for k, v in launches.items()}, row


def phase_dump(torch, tmp):
    """7e: ``launch.complete --dump-factors DIR``, restored by the port's
    checkpointer against the printed metadata."""
    from repro_torch import checkpoint
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import complete
    out = os.path.join(tmp, "factors")
    dims, sweeps = (2000, 1500, 1000), 2
    log(f"phase 7e: launch.complete --algorithm als --dims "
        f"{','.join(map(str, dims))} --dump-factors DIR")
    kops.reset_launch_counts()
    run = complete.main(["--algorithm", "als", "--dims",
                         ",".join(map(str, dims)), "--nnz", "2000000",
                         "--rank", str(RANK), "--sweeps", str(sweeps),
                         "--seed", str(SEED), "--device", "cuda",
                         "--dump-factors", out])
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    step = checkpoint.latest_step(out)
    meta = checkpoint.read_manifest(out, step)["metadata"]
    log(f"  step {step}, metadata {json.dumps(meta, sort_keys=True)}")
    if set(meta) != DUMP_KEYS or step != sweeps:
        raise SystemExit(f"phase 7e: step {step}, metadata keys "
                         f"{sorted(meta)}")
    like = {f"factor_{d}": torch.zeros(n, meta["rank"], device="cuda")
            for d, n in enumerate(meta["shape"])}
    got, _ = checkpoint.restore(out, step, like)
    for d, f in enumerate(run.factors):
        g = got[f"factor_{d}"]
        if g.device.type != "cuda" or not torch.equal(g, f):
            raise SystemExit(f"phase 7e: factor_{d} restored on {g.device} "
                             f"differs from the run's")
    log(f"  restored {len(got)} factors onto the card, equal to the run's")
    return {"dump-factors als": launches}, out


def phase_streamed(torch, tmp):
    """Phase 7: 7a to 7e, with its files under ``tmp``. Returns the
    launches of each run, the kernel rows of this phase and 7e's factor
    directory."""
    torch.cuda.reset_peak_memory_stats()
    ds, wall = phase_stream(torch)
    spec, counts = phase_experiment(torch, ds, wall, tmp)
    counts.update(phase_restart(torch, ds, spec, tmp))
    del ds
    torch.cuda.empty_cache()
    skew_counts, row = phase_skewed(torch, tmp)
    counts.update(skew_counts)
    dump_counts, dump = phase_dump(torch, tmp)
    counts.update(dump_counts)
    log(f"phase 7: passed; peak memory in phase 7 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return counts, [row], dump


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

SERVE_BATCH = 1024
SERVE_QUERIES = 1 << 20
TOPK = 10
TOPK_ITEM_QUERIES = 1024
TOPK_USER_QUERIES = 64
FOLDIN_USERS = 1024
FOLDIN_NNZ = 200           # ~ the paper's 100.5 M ratings / 480 189 users
FOLDIN_LAM = 1e-2


class Tee:
    """A stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_serve_dump(torch, path):
    """8a: ``launch.serve_complete --verify`` on phase 7e's factors."""
    import contextlib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve_complete
    argv = ["--factors", path, "--num-queries", "100000", "--batch-size",
            str(SERVE_BATCH), "--topk", str(TOPK), "--foldin-users", "32",
            "--verify", "--device", "cuda"]
    log(f"phase 8a: launch.serve_complete on phase 7e's factors "
        f"{' '.join(argv[2:])}")
    tee = Tee(sys.stdout)
    kops.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(tee):
            serve_complete.main(argv)
    except SystemExit as exc:
        raise SystemExit(f"phase 8a: serve_complete exited {exc.code}")
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    if "verify OK" not in "".join(tee.parts).splitlines():
        raise SystemExit("phase 8a: serve_complete did not print verify OK")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"phase 8a: kernels not launched: {missing}")
    log(f"  launches {launches}")
    return {"serve 7e": launches}


def distinct_row_bytes(torch, indices, factors, skip=None):
    """Bytes of the factor rows that ``indices`` (n, nd) gather, each
    distinct row once (mode ``skip`` left out)."""
    total = 0
    for d, f in enumerate(factors):
        if d != skip and f is not None:
            total += int(torch.unique(indices[:, d]).numel()) * \
                f.shape[1] * f.element_size()
    return total


def check_topk(label, fs64, fixed, target, vals, idx):
    """Hold served top-k against the float64 host scores of every item:
    the values against the true top-k values and against the true scores
    at the returned items, both within 1e-6 · max(1, max|s|)."""
    import numpy as np
    q = None
    for d in sorted(fixed):
        rows = fs64[d][fixed[d]]
        q = rows if q is None else q * rows
    full = q @ fs64[target].T
    j = full.shape[1]
    want = np.sort(np.partition(full, j - TOPK, axis=1)[:, j - TOPK:],
                   axis=1)[:, ::-1]
    lim = 1e-6 * max(1.0, float(np.abs(full).max()))
    err_v = float(np.abs(vals - want).max())
    err_i = float(np.abs(np.take_along_axis(full, idx.astype(np.int64), 1)
                         - vals).max())
    if not (np.isfinite(vals).all() and err_v <= lim and err_i <= lim):
        raise SystemExit(f"phase 8b: {label}: top-k values off by {err_v:.3e}"
                         f", scores at the returned items by {err_i:.3e} "
                         f"(limit {lim:.3e})")
    return err_v, err_i, lim


def phase_serve_netflix(torch, tmp, held_before):
    """8b: serving at the paper-netflix extents and rank, factors from the
    seed, through the engine's CUDA graphs; each endpoint held against its
    float64 host oracle, then each kernel held at its serving shape.
    ``held_before`` is the bytes allocated when phase 8 began."""
    import numpy as np
    from repro_torch import checkpoint
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import experiment
    from repro_torch.launch import serve_complete as sc
    from repro_torch.serve import ServeEngine, load_factors, percentiles
    from repro_torch.serve.foldin import omega_view
    spec = experiment.SPECS["paper-netflix"]
    shape, r = spec.shape, spec.rank
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    made = [torch.randn(n, r, generator=gen, device="cuda") / r ** 0.5
            for n in shape]
    fbytes = nbytes(*made)
    log(f"phase 8b: serving at the {spec.name} extents {shape}, R={r}: "
        f"{sum(shape)} x {r} fp32 = {fbytes / 1e6:.1f} MB of factors drawn "
        f"from N(0, 1/R) (seed {SEED}; the real ratings are not in the "
        f"repository)")
    path = os.path.join(tmp, "paper_netflix")
    meta = {"kind": "cp_factors", "rank": r, "shape": list(shape),
            "algorithm": "none", "loss": "quadratic", "link": "identity",
            "dataset": spec.name, "nnz": 0, "sweeps": 0}
    checkpoint.save(path, 0, {f"factor_{d}": f for d, f in enumerate(made)},
                    metadata=meta)
    model = load_factors(path, device="cuda")
    for d, (f, g) in enumerate(zip(model.factors, made)):
        if f.device.type != "cuda" or not torch.equal(f, g):
            raise SystemExit(f"phase 8b: factor_{d} restored on {f.device} "
                             f"differs from the one saved")
    if model.meta != meta or model.link != "identity":
        raise SystemExit(f"phase 8b: restored metadata {model.meta}")
    del made
    fs = model.factors
    fs64 = sc.host_factors(model)
    engine = ServeEngine(model, max_batch=SERVE_BATCH, device="cuda")
    rng = np.random.default_rng(SEED)
    counts = {}

    # scoring: one graph (bucket 1024), every batch a replay but the first
    queries = sc._gen_queries(rng, shape, SERVE_QUERIES)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    first = engine.score(queries[:SERVE_BATCH])
    first_s = time.perf_counter() - t0
    scores = np.empty(SERVE_QUERIES, np.float32)
    lat = []
    t_all = time.perf_counter()
    for lo in range(0, SERVE_QUERIES, SERVE_BATCH):
        t0 = time.perf_counter()
        scores[lo:lo + SERVE_BATCH] = engine.score(
            queries[lo:lo + SERVE_BATCH])
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    counts["serve paper-netflix score"] = launches = kops.launch_counts()
    calls = SERVE_QUERIES // SERVE_BATCH + 1
    if launches != {"tttp": calls, "mttkrp": 0, "cg_matvec": 0}:
        raise SystemExit(f"phase 8b: {calls} score calls launched "
                         f"{launches}, not one TTTP each")
    st = percentiles(lat)
    log(f"phase 8b score: {SERVE_QUERIES} queries in {len(lat)} batches of "
        f"{SERVE_BATCH}: {SERVE_QUERIES / wall:,.0f} QPS over {wall:.3f} s; "
        f"per batch p50 {st['p50_us']:.1f} us, p95 {st['p95_us']:.1f}, p99 "
        f"{st['p99_us']:.1f}, mean {st['mean_us']:.1f}, max "
        f"{st['max_us']:.1f}; first (capturing) call {first_s * 1e3:.1f} ms; "
        f"launches {launches} (one TTTP per call)")
    err, lim = sc.verify_scores(fs64, queries, scores, model.link)
    if not np.isfinite(scores).all() or err > lim:
        raise SystemExit(f"phase 8b: scores off the float64 oracle by "
                         f"{err:.3e} (limit {lim:.3e})")
    if not np.array_equal(first, scores[:SERVE_BATCH]):
        raise SystemExit("phase 8b: the replayed first batch differs from "
                         "its eager (capturing) call")
    log(f"  scores vs the float64 host gather chain: max|d| {err:.3e} "
        f"(limit {lim:.3e}); replay of batch 0 equal to its eager call")

    # top-10 over movies (mode 1) and over users (mode 0)
    kops.reset_launch_counts()
    topk_fixed = {}
    for target, n in ((1, TOPK_ITEM_QUERIES), (0, TOPK_USER_QUERIES)):
        fixed = topk_fixed[target] = {d: rng.integers(0, shape[d], size=n)
                                      for d in range(3) if d != target}
        t0 = time.perf_counter()
        engine.top_k(fixed, target, TOPK)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, idx = engine.top_k(fixed, target, TOPK)
        dt = time.perf_counter() - t0
        err_v, err_i, lim = check_topk(f"top-{TOPK} over mode {target}",
                                       fs64, fixed, target, vals, idx)
        blocks = -(-shape[target] // engine.topk_block)
        log(f"phase 8b top-{TOPK} over mode {target} ({shape[target]} rows, "
            f"{blocks} blocks of {engine.topk_block}) for {n} queries: "
            f"{dt * 1e3:.3f} ms per call (replay), first (capturing) call "
            f"{first_s * 1e3:.1f} ms; values vs float64 max|d| {err_v:.3e}, "
            f"scores at the returned items {err_i:.3e} (limit {lim:.3e})")
    counts["serve paper-netflix top-k"] = kops.launch_counts()

    # fold-in: 1024 cold users x 200 ratings over (movie, day) in mode 0
    hists = sc._gen_histories(rng, shape, 0, FOLDIN_USERS, FOLDIN_NNZ)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    first_rows = engine.fold_in(hists, 0)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = engine.fold_in(hists, 0)
    dt = time.perf_counter() - t0
    counts["serve paper-netflix fold-in"] = launches = kops.launch_counts()
    iters = max(4 * r, 32)
    if launches != {"tttp": 0, "mttkrp": 2, "cg_matvec": 2 * (1 + iters)}:
        raise SystemExit(f"phase 8b: two fold-in calls launched {launches}, "
                         f"not 1 MTTKRP and 1 + {iters} fused matvecs each")
    bk = engine.history_buckets(hists, 0)
    n_valid = int(bk.valid.sum())
    log(f"phase 8b fold-in: {FOLDIN_USERS} users x {FOLDIN_NNZ} ratings "
        f"({n_valid} entries, {bk.num_blocks} buckets of {bk.block_rows} "
        f"users, capacity {bk.capacity}): {dt * 1e3:.2f} ms per call "
        f"(replay), {dt * 1e6 / FOLDIN_USERS:.1f} us/user; first "
        f"(capturing) call {first_s * 1e3:.1f} ms; launches per call "
        f"mttkrp 1, cg_matvec 1 + {iters}")
    for label, got in (("eager", first_rows), ("replay", rows)):
        err = sc.verify_foldin(fs64, hists, 0, FOLDIN_LAM, got)
        if not np.isfinite(got).all() or err > 1e-4:
            raise SystemExit(f"phase 8b: fold-in ({label}) off the float64 "
                             f"explicit solve by {err:.3e} (limit 1e-4)")
        log(f"  fold-in ({label}) vs the float64 explicit one-row solve: "
            f"max|d| {err:.3e} (limit 1e-4)")
    t0 = time.perf_counter()
    engine.history_buckets(hists, 0)
    host_s = time.perf_counter() - t0
    log(f"  of which the host side (packing, bucket pattern, two device "
        f"waits): {host_s * 1e3:.2f} ms")
    profile(torch, "phase 8b: one fold-in call (replay)",
            lambda: engine.fold_in(hists, 0))
    profile(torch, f"phase 8b: one top-{TOPK} call over users (replay)",
            lambda: engine.top_k(topk_fixed[0], 0, TOPK))
    gs = engine.graph_stats()
    log(f"phase 8b graphs: {gs['captured']} captured, {gs['replays']} "
        f"replays; first calls {gs['first_call_s']:.2f} s in all; launches "
        f"per replay {gs['launches_per_replay']}")
    log(f"phase 8b: peak device memory of the serving runs (8a and 8b's "
        f"endpoints) {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.2f} "
        f"GiB above what was allocated when phase 8 began")

    # each kernel at its serving shape, against its plain version
    rows_out = []
    idx = torch.from_numpy(queries[:SERVE_BATCH]).to("cuda")
    ones = torch.ones(SERVE_BATCH, device="cuda")
    valid = torch.ones(SERVE_BATCH, dtype=torch.bool, device="cuda")
    sb = SparseTensor(idx, ones, valid, shape, SERVE_BATCH)
    err = held(torch, "tttp at the score batch", kops.tttp_values(sb, fs),
               kref.tttp_ref(ones, idx, valid, fs), "phase 8b")
    b_ms, b_by = bound(nbytes(idx, ones, valid) + 4 * SERVE_BATCH
                       + distinct_row_bytes(torch, idx, fs),
                       SERVE_BATCH * r * len(shape))
    rows_out.append(dict(
        name="tttp_serve_score", route="cuda",
        source="port/repro_torch/csrc/tttp.cu",
        replaces="src/repro/kernels/tttp.py:61",
        launches=counts["serve paper-netflix score"]["tttp"],
        max_abs_err=err,
        ms=graph_ms(torch, lambda: kops.tttp_values(sb, fs), 200),
        plain_ms=graph_ms(torch, lambda: kref.tttp_ref(ones, idx, valid, fs),
                          50),
        eager_ms=time_ms(torch, lambda: kops.tttp_values(sb, fs), 200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"score batch: m={SERVE_BATCH} nd=3 R={r} (v = 1)"))

    others = [None] + fs[1:]
    bo = omega_view(bk)
    x = torch.from_numpy(rows).to("cuda")
    batch = bk.shape[0]

    def plain_mttkrp():
        return kref.mttkrp_bucketed_ref(bk.values, bk.indices, bk.local_row,
                                        others, 0, bk.block_rows)[:batch]

    def plain_cg():
        return kref.cg_matvec_bucketed_ref(bo.values, bo.indices,
                                           bo.local_row, fs, x, 0,
                                           bo.block_rows)[:batch]

    err_m = held(torch, "mttkrp at the fold-in layout",
                 kops.mttkrp_bucketed(bk, others), plain_mttkrp(), "phase 8b")
    err_c = held(torch, "fused matvec at the fold-in layout",
                 kops.cg_matvec_bucketed(bo, fs, x), plain_cg(), "phase 8b")
    keep = bk.valid
    coo_idx = bk.indices[keep]
    coo_val = bk.values[keep]
    cols = [coo_idx[:, d].long() for d in range(3)]

    def library_mttkrp():
        prod = coo_val[:, None] * fs[1][cols[1]] * fs[2][cols[2]]
        return torch.zeros(batch, r, device="cuda").index_add_(0, cols[0],
                                                               prod)

    # the function needs the valid entries only: their bytes, the factor
    # rows they gather (each once), x and the output
    entry_bytes = n_valid * sum(t[0, 0].numel() * t.element_size() for t in
                                (bk.values, bk.indices, bk.local_row,
                                 bk.valid))
    frows = distinct_row_bytes(torch, coo_idx, fs, skip=0)
    out_bytes = 4 * batch * r
    shape_note = (f"fold-in: nb={bk.num_blocks} C={bk.capacity} "
                  f"block_rows={bk.block_rows} R={r} valid={n_valid}")
    b_ms, b_by = bound(entry_bytes + frows + out_bytes, n_valid * r * 3)
    rows_out.append(dict(
        name="mttkrp_serve_foldin", route="cuda",
        source="port/repro_torch/csrc/mttkrp.cu",
        replaces="src/repro/kernels/mttkrp.py:83",
        launches=counts["serve paper-netflix fold-in"]["mttkrp"],
        max_abs_err=err_m,
        ms=graph_ms(torch, lambda: kops.mttkrp_bucketed(bk, others), 50),
        plain_ms=graph_ms(torch, plain_mttkrp, 20), bound_ms=b_ms,
        bound_by=b_by, library_ms=graph_ms(torch, library_mttkrp, 50),
        eager_ms=time_ms(torch, lambda: kops.mttkrp_bucketed(bk, others),
                         50),
        shape=shape_note))
    b_ms, b_by = bound(entry_bytes + frows + nbytes(x) + out_bytes,
                       n_valid * r * 5)
    rows_out.append(dict(
        name="cg_matvec_serve_foldin", route="cuda",
        source="port/repro_torch/csrc/cg_matvec.cu",
        replaces="src/repro/kernels/cg_matvec.py:66",
        launches=counts["serve paper-netflix fold-in"]["cg_matvec"],
        max_abs_err=err_c,
        ms=graph_ms(torch, lambda: kops.cg_matvec_bucketed(bo, fs, x), 50),
        plain_ms=graph_ms(torch, plain_cg, 20), bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        eager_ms=time_ms(torch, lambda: kops.cg_matvec_bucketed(bo, fs, x),
                         50),
        shape=shape_note))
    for row in rows_out:
        log(f"phase 8b: {row['name']:<22} {row['ms']:9.4f} ms  plain "
            f"{row['plain_ms']:9.4f} ms  bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']})  library {row['library_ms']}  "
            f"max|err| {row['max_abs_err']:.2e}  [{row['shape']}]; eager "
            f"back-to-back wrapper calls {row['eager_ms']:.4f} ms")
    log("phase 8b: kernel, plain and library times are device times of "
        "calls captured in one CUDA graph (graph_ms), as the engine replays "
        "them; eager is the host-bound rate of back-to-back wrapper calls")
    return counts, rows_out


def phase_serve(torch, dump):
    """Phase 8: 8a and 8b. Returns the launches of each run and the kernel
    rows of this phase."""
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    log(f"phase 8: {held / 2**30:.2f} GiB allocated by earlier phases at "
        f"its start")
    counts = phase_serve_dump(torch, dump)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        more, rows = phase_serve_netflix(torch, tmp, held)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts.update(more)
    log(f"phase 8: passed; peak memory in phase 8 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the timing "
        f"graphs of the plain versions included)")
    return counts, rows


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

# forced planner candidates whose estimated memory traffic is at most this
# many words (16 GiB of float32, a fifth of the card's 80 GB); at the main
# path's size it leaves out dense, kr_first and t_first (whose sort traffic
# the cost model prices at 3.4e10 words)
PLAN_MEM_WORDS = 2 ** 32
# 9c: every candidate (dense included) at phase 7e's dims
SMALL_DIMS = (2000, 1500, 1000)
SMALL_NNZ = 2_000_000
PLAN_REPS = 3


def planner_sweep(torch, run, path):
    """One ALS sweep of phase 3's problem from its initial factors with
    ``--matvec-path path``; returns the run and its launches."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import complete
    args = complete.build_parser().parse_args(
        ["--algorithm", "als"] + main_argv() + ["--matvec-path", path])
    args.sweeps = 1
    kops.reset_launch_counts()
    out = complete.run_solver(args, run.dataset, run.init_factors)
    torch.cuda.synchronize()
    return out, kops.launch_counts()


def _values(out):
    """A result's values: a SparseTensor's (TTTP), or the dense tensor."""
    from repro_torch.core.sparse_tensor import SparseTensor
    return out.values if isinstance(out, SparseTensor) else out


def forced_paths(torch, label, families):
    """Every candidate of each (family, expr, operands, plain) whose
    estimated memory is at most ``PLAN_MEM_WORDS``, forced through
    ``ctf.einsum``: held (phase 4's tolerance) against ``plain()``, a plain
    PyTorch result on the same inputs independent of the planner, or,
    where ``plain`` is None, against the default path's output; timed by
    CUDA events. ``obs`` is on for the one counted call of each candidate,
    so its ``PlanRecord`` (predicted beside fenced wall time) is kept.
    Returns the launches of the counted calls and (flops, words, seconds)
    samples."""
    import repro_torch.core.api as ctf
    from repro_torch import obs
    from repro_torch.kernels import ops as kops
    counts = {k: 0 for k in kops.launch_counts()}
    samples = []
    for family, expr, ops, plain in families:
        plan = ctf.plan(expr, *ops)
        want = plain() if plain else _values(ctf.einsum(expr, *ops))
        torch.cuda.synchronize()
        skipped = [c.path for c in plan.ranking if c.mem > PLAN_MEM_WORDS]
        log(f"  {label} {family} {expr}: default {plan.path}, ranking "
            f"{[c.path for c in plan.ranking]}, left out (estimated memory "
            f"> 2^32 words): {skipped}; each path held against "
            f"{'the plain version' if plain else 'the default path'}")
        for c in plan.ranking:
            if c.mem > PLAN_MEM_WORDS:
                continue
            kops.reset_launch_counts()
            obs.enable()
            try:
                got = _values(ctf.einsum(expr, *ops, path=c.path))
                torch.cuda.synchronize()
            finally:
                obs.disable()
            for k, n in kops.launch_counts().items():
                counts[k] += n
            err = held(torch, f"{family} {c.path}", got, want,
                       where=f"phase 9 ({label})")
            del got
            ms = time_ms(torch, lambda: ctf.einsum(expr, *ops, path=c.path),
                         PLAN_REPS)
            samples.append((c.flops, c.mem, ms / 1e3))
            log(f"    {c.path:12s} {ms:10.3f} ms  predicted "
                f"{c.seconds * 1e3:10.3f} ms (flops {c.flops:.3e}, words "
                f"{c.mem:.3e})  max |path - reference| {err:.2e}")
        del want
        torch.cuda.empty_cache()
    plans = obs.get_registry().summary()["plans"]
    for key, rec in sorted(plans.items()):
        log(f"    PlanRecord {key}: predicted "
            f"{rec['predicted']['seconds'] * 1e3:.3f} ms, fenced wall "
            f"{rec['measured']['mean_s'] * 1e3:.3f} ms "
            f"(x{rec['measured_over_predicted']:.2f})")
    obs.get_registry().reset()
    return counts, samples


def plain_mttkrp(st, fs):
    """The plain mode-0 MTTKRP of ``st`` (``sparse.ops.mttkrp``: gather,
    product, ``index_add_``), deferred."""
    from repro_torch.sparse import ops as sops
    return lambda: sops.mttkrp(st, [None, fs[1], fs[2]], 0)


def plain_reduce(torch, st):
    """The plain ``ijk->i`` of ``st``: its masked values summed by
    ``index_add_`` over int64 row indices, deferred."""
    def run():
        out = torch.zeros(st.shape[0], dtype=st.values.dtype,
                          device=st.values.device)
        return out.index_add_(0, st.indices[:, 0].long(),
                              st.masked_values())
    return run


def phase_planner(torch, run):
    """Phase 9a-9d on phase 3's tensor: ALS with the planner's matvec
    paths, every forced candidate at full size, the dense and pairwise
    candidates at 7e's dims, and one autotuned plan. Returns the launches
    of each run."""
    from repro_torch import planner
    from repro_torch.data import synthetic
    from repro_torch.planner import cost as pcost
    counts = {}
    fused_ms = run.history[0][1] * 1e3
    # one sweep of phase 3's fused run, and the RMSE before and after it
    per_sweep = dict(run.sweep_launches[0], tttp=2)
    log("phase 9a: ALS sweeps through the planner's Gram matvec "
        "(--matvec-path auto, sliced), from phase 3's initial factors")
    auto, counts["planner als auto"] = planner_sweep(torch, run, "auto")
    if counts["planner als auto"] != per_sweep:
        raise SystemExit(f"phase 9a: --matvec-path auto launched "
                         f"{counts['planner als auto']}, the fused sweep "
                         f"{per_sweep}")
    h = pcost._sliced_h(RANK)
    matvecs = 3 * (1 + CG_ITERS)
    sliced, counts["planner als sliced"] = planner_sweep(torch, run,
                                                         "sliced")
    want = {"tttp": 2 + h * matvecs, "mttkrp": 3 + h * matvecs,
            "cg_matvec": 0}
    if counts["planner als sliced"] != want:
        raise SystemExit(f"phase 9a: --matvec-path sliced launched "
                         f"{counts['planner als sliced']}, expected {want}")
    for name, other, rtol in (("auto", auto, 1e-4), ("sliced", sliced, 1e-3)):
        for d, (a, b) in enumerate(zip(other.factors, run.sweep_factors[0])):
            scale = float(b.abs().max())
            torch.testing.assert_close(
                a, b, rtol=rtol, atol=rtol * scale,
                msg=lambda m: f"phase 9a: factor {d}, {name} vs fused: {m}")
            log(f"  {name} factor {d}: max |{name} - fused| = "
                f"{float((a - b).abs().max()):.3e}")
    log(f"  sweep ms: fused {fused_ms:.1f} (phase 3), auto "
        f"{auto.history[0][1] * 1e3:.1f}, sliced "
        f"{sliced.history[0][1] * 1e3:.1f} (H = {h}); launches auto "
        f"{counts['planner als auto']}, sliced {counts['planner als sliced']}")
    del auto, sliced

    st, omega = run.dataset.tensor, run.dataset.omega
    fs = run.factors
    log(f"phase 9b: every forced candidate at the main path's size "
        f"(m = {NNZ}, R = {RANK}) within {PLAN_MEM_WORDS} words; rates "
        f"{pcost.rates()} (H100 SXM data sheet)")
    big = [("mttkrp", "ijk,jr,kr->ir", (st, fs[1], fs[2]),
            plain_mttkrp(st, fs)),
           ("tttp", "ijk,ir,jr,kr->ijk", (st, *fs), None),
           ("cg_matvec", "ijk,jr,kr,iy,jy,ky->ir",
            (omega, fs[1], fs[2], fs[0], fs[1], fs[2]), None),
           ("reduce", "ijk->i", (st,), plain_reduce(torch, st))]
    counts["planner forced 80M"], samples = forced_paths(torch, "80M", big)

    log(f"phase 9c: every candidate at phase 7e's dims {SMALL_DIMS}, "
        f"nnz {SMALL_NNZ} (dense, kr_first, t_first and TTM included)")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    small = synthetic.function_tensor(SMALL_DIMS, SMALL_NNZ, gen)
    sw = small.with_values(small.valid.to(small.values.dtype))
    g = [torch.randn(n, RANK, generator=gen, device="cuda") / RANK ** 0.5
         for n in SMALL_DIMS]
    little = [("mttkrp", "ijk,jr,kr->ir", (small, g[1], g[2]),
               plain_mttkrp(small, g)),
              ("tttp", "ijk,ir,jr,kr->ijk", (small, *g), None),
              ("cg_matvec", "ijk,jr,kr,iy,jy,ky->ir",
               (sw, g[1], g[2], g[0], g[1], g[2]), None),
              ("reduce", "ijk->i", (small,), plain_reduce(torch, small)),
              ("ttm", "ijk,kr->ijr", (small, g[2]), None)]
    counts["planner forced 7e dims"], more = forced_paths(torch, "7e dims",
                                                          little)
    samples += more
    del small, sw, g
    torch.cuda.empty_cache()
    fitted = pcost.calibrate(samples)
    pcost.reset_rates()
    log(f"  rates fitted by cost.calibrate to the {len(samples)} samples "
        f"of 9b and 9c (printed, not installed): flop "
        f"{fitted['flop']:.4g} FMA/s, mem {fitted['mem']:.4g} words/s "
        f"(data sheet {pcost.FLOP_RATE:.4g}, {pcost.MEM_RATE:.4g})")

    log("phase 9d: one autotuned plan (the Gram matvec at the main path's "
        "size)")
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    plan = planner.plan_contraction(
        "ijk,jr,kr,iy,jy,ky->ir", (omega, fs[1], fs[2], fs[0], fs[1], fs[2]),
        autotune=True)
    torch.cuda.synchronize()
    counts["planner autotune"] = kops.launch_counts()
    log(f"  timings (fenced best of 3) "
        f"{[(p, round(t * 1e3, 3)) for p, t in plan.timings]} ms, winner "
        f"{plan.path}, cost model's pick {plan.ranking[0].path}")
    if not plan.autotuned or plan.path not in plan.candidates:
        raise SystemExit(f"phase 9d: autotune gave {plan}")
    torch.cuda.empty_cache()
    log(f"phase 9a-9d: passed; peak memory so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return counts


def phase_planner_serve(torch, dump):
    """Phase 9e: ``serve_complete --score-path all_at_once --matvec-path
    sliced --verify`` on 7e's factors: scoring through the planner's TTTP,
    fold-in on the planner's H-sliced matvec (TTTP then MTTKRP, no fused
    matvec)."""
    import contextlib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve_complete
    argv = ["--factors", dump, "--num-queries", "100000", "--batch-size",
            str(SERVE_BATCH), "--topk", str(TOPK), "--foldin-users", "32",
            "--score-path", "all_at_once", "--matvec-path", "sliced",
            "--verify", "--device", "cuda"]
    log(f"phase 9e: launch.serve_complete {' '.join(argv[2:])}")
    tee = Tee(sys.stdout)
    kops.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(tee):
            serve_complete.main(argv)
    except SystemExit as exc:
        raise SystemExit(f"phase 9e: serve_complete exited {exc.code}")
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    if "verify OK" not in "".join(tee.parts).splitlines():
        raise SystemExit("phase 9e: serve_complete did not print verify OK")
    if not launches["tttp"] or not launches["mttkrp"] or \
            launches["cg_matvec"]:
        raise SystemExit(f"phase 9e: launches {launches}: the sliced "
                         f"fold-in runs TTTP and the MTTKRP, no fused matvec")
    log(f"  launches {launches}")
    return {"serve 7e planner": launches}


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
    # phase 9a-9d run on phase 3's dataset too, before it is freed
    planner_counts = phase_planner(torch, run)
    # free phase 3's dataset (phases 6 and 9 ran on it) before phase 7
    del run
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stream_counts, stream_rows, dump = phase_streamed(torch, tmp)
        kernels += stream_rows
        torch.cuda.empty_cache()
        serve_counts, serve_rows = phase_serve(torch, dump)
        kernels += serve_rows
        planner_counts.update(phase_planner_serve(torch, dump))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # phase 10: each kernel's launches in every run of phases 3, 6, 7, 8
    # and 9, each counted from zero
    paths = {"als fused": launches, "als tttp_mttkrp": other_launches,
             **solver_counts, **stream_counts, **serve_counts,
             **planner_counts}
    for row in kernels:
        group = next(g for g in ("tttp", "mttkrp", "cg_matvec")
                     if row["name"].startswith(g))
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
