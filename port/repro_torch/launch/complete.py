"""Tensor-completion CLI, on one device or over a grid of ranks:

    python -m repro_torch.launch.complete --algorithm als --dataset function \\
        --dims 200,180,160 --nnz 200000 --rank 10 --sweeps 10 \\
        [--loss quadratic] [--matvec-path fused|tttp_mttkrp|auto|sliced|dense] \\
        [--ckpt-dir DIR] [--dump-factors DIR|PATH.npz] [--device cuda|cpu] \\
        [--plan-cache PATH] [--mesh 4,2 [--dist-backend nccl|gloo]] \\
        [--mesh 4,2 --device cpu --force-host-devices 8]

Algorithms, as in the reference: ``als`` (implicit-CG ALS, quadratic
loss), ``ccd``/``ccd_tttp`` (CCD++, gather/segment-sum or TTTP-routed),
``sgd`` (sampled gradient, ``--lr``, ``--sample-rate``), ``gcp`` (first-order
generalized loss, Adam, ``--lr``) and ``ggn`` (damped generalized
Gauss-Newton on the eq.-3 Gram matvec with curvature weights,
``--damping``). ``--loss`` picks one of ``core.losses.LOSSES`` for ``gcp``
and ``ggn``; the other algorithms fit the quadratic loss whatever it says.
On ``cuda`` the sweeps run the three hand-written kernels: TTTP for model
values and the RMSE, the bucketed MTTKRP for right-hand sides and
gradients, and the fused CG matvec (or TTTP + bucketed MTTKRP with
``--matvec-path tttp_mttkrp``) in the CG loops of ``als`` and ``ggn``;
``--matvec-path auto|sliced|dense`` runs that matvec through the planner
(``auto``: the cost model picks, ``fused`` at the usual shapes).
``--block-rows`` sets the planner's bucket granularity
(``planner.set_default_config``), so ingest and dispatch read one view.
``--dataset`` is the function tensor or the Netflix-shaped ratings tensor
(``data.synthetic.netflix_like``, three dims). ``--init-npz`` loads the
tensor (``indices``, ``values``, ``valid``, ``shape``) and the initial
``factor_<d>`` from a file, so a run can start from the JAX package's
arrays. Each sweep prints ``sweep i  <ms> ms  rmse=<rmse>``, its time fenced
by ``torch.cuda.synchronize()``, and for ``gcp`` and ``ggn`` the objective
they lower on the same line (``ggn`` also its damping).

``--ckpt-dir DIR`` runs the sweeps through ``runtime.RestartableLoop``
(a checkpoint every 5 sweeps and one at the end) and resumes from the
newest checkpoint in DIR. Unlike the reference, which checkpoints into
``/tmp/repro_completion_ckpt`` by default, the flag has no default: without
it nothing is checkpointed and nothing resumed. ``--dump-factors PATH.npz``
writes the final ``factor_<d>``; any other path is a checkpoint directory,
written as the reference writes it (step = ``--sweeps``, leaves
``factor_<d>``, metadata ``kind``, ``rank``, ``shape``, ``algorithm``,
``loss``, ``link``, ``dataset``, ``nnz``, ``sweeps``).

``--plan-cache PATH`` (or ``REPRO_PLAN_CACHE``) tunes the kernels' launch
shapes on the run's tensor before the first sweep (``planner.tuner``) and
keeps the winners in PATH, so a second run of the same workload restores
them without timing anything; it prints ``plan-cache: hits= measured=
footprint_pruned= winners=``.

Distribution: ``--mesh R,C`` lays ``R·C`` ranks out as a ``("data",
"model")`` grid (names per ``--mesh-axes``; ``--data-axes`` shard the
nonzeros, the first other axis the factor columns), spawns them
(``torch.multiprocessing``, ``spawn``: the caller may hold a CUDA
context) with a ``FileStore`` rendezvous in a fresh temporary directory
and runs every sweep under the rank's ``AxisCtx``: the same algorithm
code, its psums all-reduces over the ranks' process groups. Every rank
makes the same dataset and factors from the seed and keeps its shard and
column slice; CCD++ keeps whole factors (no model axis). ``--dist-backend``
is the transport: ``nccl`` (default on ``cuda``: one card per rank) or
``gloo`` (default on ``cpu``; on ``cuda`` ranks beyond the card count
share cards, ``rank % device_count``, and every collective copies through
host memory, counted). ``--force-host-devices N`` runs N ranks on the CPU
over gloo (with ``--device cpu``). On ``cuda`` the kernel library is
built once before the ranks start. Only rank 0 prints; the sweep time is
rank 0's host clock between barriers; RMSE is the local squared error and
count psum'd over the data axes; ``--dump-factors`` and ``--ckpt-dir``
write the logical (gathered) arrays from rank 0. ``--plan-cache`` is
skipped under ``--mesh`` (the tiles are tuned on one device), as in the
reference; so is a ``fused`` or ``dense`` Gram matvec under a model axis,
which runs the cost model's choice. A failed rank fails the run.
:func:`main` then returns a :class:`MeshRun` (every rank's record).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import interop, obs
from repro_torch.core import losses as LOSS
from repro_torch.core.completion import GGNState, make_step
from repro_torch.core.completion.als import MATVEC_PATHS
from repro_torch.core.completion.gcp import gcp_loss
from repro_torch.core import collectives as coll
from repro_torch.core.distributed import LOCAL, AxisCtx, DistLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values
from repro_torch.data import synthetic
from repro_torch.data.pipeline import CompletionDataset
from repro_torch.kernels import ops as kops
from repro_torch.planner import (PlannerConfig, ensure_tuned,
                                 set_default_config)
from repro_torch.runtime import RestartableLoop

ALGORITHMS = ("als", "ccd", "ccd_tttp", "sgd", "gcp", "ggn")
# a rank that stops answering fails the others' collectives after this
DIST_TIMEOUT = datetime.timedelta(seconds=300)
# flag sets under which a ggn run computes the same iterates and sums them
# in another float32 order (bucket granularity, matvec route): the LOCAL
# envelope a mesh run's objectives are read against
GGN_SUMMATION_ORDERS = ((), ("--matvec-path", "tttp_mttkrp"),
                        ("--block-rows", "4"), ("--block-rows", "16"),
                        ("--matvec-path", "tttp_mttkrp", "--block-rows",
                         "16"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.complete",
        description="tensor completion on one device or a grid of ranks")
    ap.add_argument("--dataset", default="function",
                    choices=["function", "netflix"])
    ap.add_argument("--algorithm", default="als", choices=ALGORITHMS)
    ap.add_argument("--loss", default="quadratic")
    ap.add_argument("--dims", default="200,180,160")
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sample-rate", type=float, default=0.1)
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--cg-tol", type=float, default=1e-4,
                    help="batched-CG relative residual tolerance (als/ggn)")
    ap.add_argument("--damping", type=float, default=1e-5,
                    help="initial Levenberg-Marquardt damping (ggn)")
    ap.add_argument("--block-rows", type=int, default=8,
                    help="CCSR bucket granularity (output rows per CTA)")
    ap.add_argument("--matvec-path", default="fused",
                    choices=MATVEC_PATHS,
                    help="Gram matvec of als and ggn: one fused kernel, "
                         "TTTP then bucketed MTTKRP, or through the planner "
                         "(auto: the cost model picks; sliced; dense)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generators behind data, initial "
                         "factors and SGD samples")
    ap.add_argument("--init-npz", default=None, metavar="PATH",
                    help="load the tensor (indices, values, valid, shape) "
                         "and initial factor_<d> from PATH")
    ap.add_argument("--dump-factors", default=None, metavar="PATH",
                    help="write the final factors as factor_0..factor_{N-1}: "
                         "an .npz file, or else a checkpoint directory with "
                         "the run's metadata")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint every 5 sweeps into DIR and resume from "
                         "its newest checkpoint (no default: without it "
                         "nothing is checkpointed)")
    ap.add_argument("--mesh", default=None, metavar="R,C",
                    help="grid shape, e.g. '4,2' = 4-way data x 2-way "
                         "model; spawns that many ranks")
    ap.add_argument("--mesh-axes", default="data,model",
                    help="axis names matching --mesh (comma list)")
    ap.add_argument("--data-axes", default="data",
                    help="which grid axes shard the nonzeros (comma list); "
                         "the first other axis column-shards the factors")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    metavar="N",
                    help="N ranks on the CPU over gloo (with --device cpu): "
                         "the CPU stand-in for several cards")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="transport of --mesh: nccl (default on cuda, one "
                         "card per rank) or gloo (default on cpu; on cuda "
                         "ranks share cards and collectives copy through "
                         "host memory)")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="tune the kernels' launch shapes before the first "
                         "sweep and keep the winners in PATH (default: "
                         "REPRO_PLAN_CACHE; neither: no tuning)")
    return ap


def check_supported(args) -> None:
    """Refuse what the port does not run yet, and unknown losses."""
    if args.loss not in LOSS.LOSSES:
        raise SystemExit(f"unknown --loss {args.loss}; "
                         f"choices: {sorted(LOSS.LOSSES)}")
    if args.dataset == "netflix" and args.init_npz is None and \
            len(args.dims.split(",")) != 3:
        raise SystemExit("--dataset netflix: --dims takes three sizes "
                         "(users, movies, days)")
    if args.mesh is not None:
        check_mesh(args)
    elif args.force_host_devices:
        raise SystemExit("--force-host-devices: give --mesh too")


def mesh_layout(args, rank: Optional[int] = None) -> DistLayout:
    """The grid of ``--mesh``: row-major ranks, the nonzeros over
    ``--data-axes``, the factor columns over the first other axis (none
    for CCD++, which updates whole columns)."""
    grid = tuple(int(x) for x in args.mesh.split(","))
    axes = tuple(a.strip() for a in args.mesh_axes.split(","))
    data_axes = tuple(a for a in args.data_axes.split(",") if a)
    model_axes = [a for a in axes if a not in data_axes]
    model_axis = model_axes[0] if model_axes else None
    if args.algorithm in ("ccd", "ccd_tttp"):
        model_axis = None
    return DistLayout(grid, data_axes, model_axis, axes,
                      rank=0 if rank is None else rank)


def mesh_backend(args) -> str:
    return args.dist_backend or ("nccl" if args.device.startswith("cuda")
                                 else "gloo")


def check_mesh(args) -> None:
    """Refuse a ``--mesh`` that cannot run as asked, before any rank
    starts."""
    try:
        layout = mesh_layout(args)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    need = layout.world_size
    backend = mesh_backend(args)
    if args.device == "cpu":
        if backend != "gloo":
            raise SystemExit("--mesh on cpu runs over gloo; nccl needs "
                             "cards")
        if args.force_host_devices < need:
            raise SystemExit(
                f"--mesh {args.mesh} needs {need} devices but only "
                f"{max(args.force_host_devices, 1)} are visible; on CPU pass "
                f"--force-host-devices {need}")
    else:
        if args.force_host_devices:
            raise SystemExit("--force-host-devices runs ranks on the CPU: "
                             "pass --device cpu")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if need > have and backend == "nccl":
            raise SystemExit(
                f"--mesh {args.mesh} needs {need} devices but only {have} "
                f"are visible; nccl takes one card per rank: pass "
                f"--dist-backend gloo to share the cards among the ranks")
        if have == 0:
            raise SystemExit(f"--mesh {args.mesh} on {args.device}: no CUDA "
                             f"card is visible")
    m = layout.model_size
    if m > 1 and args.init_npz is None and args.rank % m:
        raise SystemExit(f"--rank {args.rank} is not a multiple of the "
                         f"model axis size {m}")


@dataclasses.dataclass
class Run:
    """What a run leaves behind: the ingested dataset, the initial and final
    factors, the RMSE before the first sweep, ``(sweep, seconds, rmse)`` per
    sweep, the factors after each sweep, each sweep's kernel launches and
    collectives (``core.collectives.counts``, all zero on one device). For
    ``gcp`` and ``ggn`` also the objective, before the first sweep and
    after each, and for ``ggn`` the damping after each sweep. A run resumed
    from ``--ckpt-dir`` records only the sweeps it ran. Under ``--mesh``
    the factors are the logical (gathered) arrays, ``dataset`` is the
    rank's shard, and ``run_launches`` and ``run_collectives`` hold the
    rank's kernel launches and collectives over the whole run (ingest,
    RMSE and dumps included)."""
    dataset: Optional[CompletionDataset]
    init_factors: List[torch.Tensor]
    factors: List[torch.Tensor]
    rmse0: float
    history: List[Tuple[int, float, float]]
    sweep_factors: List[List[torch.Tensor]]
    sweep_launches: List[Dict[str, int]]
    objective: List[float]
    damping: List[float]
    sweep_collectives: List[Dict[str, int]] = dataclasses.field(
        default_factory=list)
    run_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    run_collectives: Dict[str, int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class MeshRun:
    """A ``--mesh`` run as its ranks recorded it: ``runs[r]`` is rank r's
    :class:`Run` (``dataset`` None, tensors on the CPU), whose launches and
    collectives are that rank's; every rank holds the logical factors, the
    RMSE and the objective, and rank 0's clock times the sweeps."""
    grid: Tuple[int, ...]
    backend: str
    runs: List[Run]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` when it is a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rmse(st: SparseTensor, factors: Sequence[torch.Tensor],
         ctx: AxisCtx = LOCAL) -> float:
    """RMSE over the valid entries. Under a ctx: the model values psum'd
    over the model axis, then the local squared error and count psum'd
    over the data axes (one all-reduce), then the root (the reference
    gathers the global error eagerly instead). The device work runs in
    the device-timed ``obs`` span ``complete/rmse``."""
    with obs.span("complete/rmse", device=True):
        model = ctx.psum_model(multilinear_values(st, factors))
        d = (st.values - model) * st.mask
        sq, n = (d * d).sum(), st.mask.sum()
        if ctx.data is not None:
            sq, n = ctx.psum_data(torch.stack([sq, n.to(sq.dtype)]))
        e = torch.sqrt(sq / torch.clamp(n, min=1))
    return float(e)


def load_problem(args, layout: Optional[DistLayout] = None
                 ) -> Tuple[CompletionDataset, List[torch.Tensor]]:
    """Make (or load) the tensor, ingest it and draw the initial factors;
    under ``layout``, this rank's shard and column slices of them."""
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.init_npz is not None:
        with np.load(args.init_npz) as z:
            shape = tuple(int(s) for s in z["shape"])
            raw = interop.sparse_from_numpy(z["indices"], z["values"],
                                            z["valid"], shape, device)
            factors = interop.factors_from_numpy(
                [z[f"factor_{d}"] for d in range(len(shape))], device)
    else:
        shape = tuple(int(x) for x in args.dims.split(","))
        if args.dataset == "netflix":
            raw = synthetic.netflix_like(shape, args.nnz, gen)
        else:
            raw = synthetic.function_tensor(shape, args.nnz, gen)
        factors = None
    ds = CompletionDataset(raw, gen, block_rows=args.block_rows, mesh=layout)
    del raw
    if factors is None:
        r = args.rank
        factors = [torch.randn(d, r, generator=gen, device=device) / r ** 0.5
                   for d in shape]
    if layout is not None:
        factors = [layout.factor_cols(f) for f in factors]
    return ds, factors


def _spec(key: str, leaf) -> tuple:
    """The spec of a solver-state leaf: matrices are factors or optimiser
    moments (columns over the model axis), vectors CCD++'s residual (over
    the nonzeros), scalars replicated."""
    dim = getattr(leaf, "dim", lambda: 0)()
    return {2: (None, "model"), 1: ("data",)}.get(dim, ())


def _logical(fs: Sequence[torch.Tensor], layout: Optional[DistLayout]
             ) -> List[torch.Tensor]:
    if layout is None:
        return list(fs)
    return [layout.gather(f, (None, "model")) for f in fs]


def run_solver(args, ds: CompletionDataset,
               factors: Sequence[torch.Tensor],
               layout: Optional[DistLayout] = None) -> Run:
    """``args.sweeps`` sweeps of ``args.algorithm`` from ``factors``,
    through ``RestartableLoop`` when ``args.ckpt_dir`` is set; under
    ``layout`` on this rank's shard and column slices."""
    st = ds.tensor
    device = st.device
    ctx = layout.ctx if layout is not None else LOCAL
    loss = LOSS.LOSSES[args.loss]
    with_objective = args.algorithm in ("gcp", "ggn")
    state0, step, get_factors = make_step(
        args.algorithm, st, ds.omega, factors, lam=args.lam,
        block_rows=ds.block_rows, loss=args.loss, cg_tol=args.cg_tol,
        cg_iters=args.cg_iters, matvec_path=args.matvec_path, lr=args.lr,
        sample_rate=args.sample_rate, damping=args.damping, seed=args.seed,
        ctx=ctx, nnz=ds.global_nnz)
    e0 = rmse(st, factors, ctx)
    objective = []
    line = f"sweep   -  initial      rmse={e0:.6f}"
    if with_objective:
        objective.append(float(gcp_loss(st, factors, loss, args.lam, ctx)))
        line += f"  objective={objective[0]:.6g}"
    print(line)
    hist, per_sweep, launches, damping, comms = [], [], [], [], []

    def fence():
        synchronize(device)
        if layout is not None:
            layout.barrier()

    def loop_step(i, state):
        fence()
        before, c_before = kops.launch_counts(), coll.counts()
        t0 = time.perf_counter()
        state = step(i, state)
        fence()
        dt = time.perf_counter() - t0
        after, c_after = kops.launch_counts(), coll.counts()
        launches.append({k: after[k] - before[k] for k in after})
        comms.append({k: c_after[k] - c_before[k] for k in c_after})
        fs = get_factors(state)
        e = rmse(st, fs, ctx)
        hist.append((i, dt, e))
        per_sweep.append(_logical(fs, layout))
        line = f"sweep {i:3d}  {dt * 1e3:8.1f} ms  rmse={e:.6f}"
        if with_objective:
            objective.append(float(gcp_loss(st, fs, loss, args.lam, ctx)))
            line += f"  objective={objective[-1]:.6g}"
        if isinstance(state, GGNState):
            damping.append(float(state.damping))
            line += f"  damping={damping[-1]:.3g}"
        print(line)
        return state

    if args.ckpt_dir:
        state = RestartableLoop(args.ckpt_dir, loop_step, ckpt_every=5,
                                layout=layout, spec_fn=_spec).run(
            state0, args.sweeps)
    else:
        state = state0
        for i in range(args.sweeps):
            state = loop_step(i, state)
    final = _logical(get_factors(state), layout)
    if hist:
        print(f"final rmse={hist[-1][2]:.6f} "
              f"(mean sweep {sum(h[1] for h in hist) / len(hist) * 1e3:.1f}"
              f" ms)")
    elif args.ckpt_dir:
        print(f"final rmse={rmse(st, get_factors(state), ctx):.6f} (all "
              f"{args.sweeps} sweeps restored from {args.ckpt_dir})")
    return Run(ds, _logical(factors, layout), final, e0, hist, per_sweep,
               launches, objective, damping, comms)


def dump_factors(args, run: Run) -> None:
    """Write the final factors to ``args.dump_factors``: an ``.npz``, or a
    checkpoint directory with the reference's metadata."""
    fs = run.factors
    st = run.dataset.tensor
    if args.dump_factors.endswith(".npz"):
        np.savez(args.dump_factors,
                 **{f"factor_{d}": f.cpu().numpy() for d, f in enumerate(fs)})
    else:
        link = "log" if args.loss.endswith("_log") else "identity"
        ckpt.save(args.dump_factors, args.sweeps,
                  {f"factor_{d}": f for d, f in enumerate(fs)},
                  metadata={"kind": "cp_factors", "rank": fs[0].shape[1],
                            "shape": list(st.shape),
                            "algorithm": args.algorithm, "loss": args.loss,
                            "link": link, "dataset": args.dataset,
                            "nnz": int(run.dataset.global_nnz),
                            "sweeps": args.sweeps})
    print(f"wrote factors to {args.dump_factors}")


def run_main(args, layout: Optional[DistLayout] = None) -> Run:
    """Ingest, tune, solve and dump, as one rank of ``layout`` or on one
    device."""
    # ingest (CompletionDataset) and planner dispatch read one bucket view
    set_default_config(PlannerConfig(block_rows=args.block_rows))
    t0 = time.perf_counter()
    ds, factors = load_problem(args, layout)
    synchronize(ds.tensor.device)
    st = ds.tensor
    rank = factors[0].shape[1] * (layout.model_size if layout else 1)
    print(f"dataset={args.dataset} shape={st.shape} nnz={ds.global_nnz} "
          f"rank={rank} algorithm={args.algorithm} "
          f"loss={args.loss} matvec_path={args.matvec_path} "
          f"block_rows={ds.block_rows} "
          f"device={st.device} ingest={time.perf_counter() - t0:.2f} s")
    # the tiles are installed before the first sweep launches anything
    plan_cache = args.plan_cache or os.environ.get("REPRO_PLAN_CACHE")
    if plan_cache and layout is not None:
        print("note: --plan-cache tuning skipped under --mesh (tiles are "
              "tuned on single-device eager kernels)")
    elif plan_cache:
        summary = ensure_tuned(st, factors, omega=ds.omega,
                               cache_path=plan_cache)
        print(f"plan-cache: hits={summary['hits']} "
              f"measured={summary['measured']} "
              f"footprint_pruned={summary['footprint_pruned']} "
              f"winners={summary['winners']}")
    run = run_solver(args, ds, factors, layout)
    if args.dump_factors and (layout is None or layout.rank == 0):
        dump_factors(args, run)
    if layout is not None:
        layout.barrier()
    return run


def _rank_main(rank: int, args, tmp: str) -> None:
    """One rank of a ``--mesh`` run (the target of the spawned processes):
    join the process group, run, and leave this rank's record in ``tmp``."""
    layout = mesh_layout(args, rank)
    backend = mesh_backend(args)
    if args.device != "cpu":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        args.device = str(device)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // layout.world_size))
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    import torch.distributed as dist
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                      layout.world_size),
        rank=rank, world_size=layout.world_size, timeout=DIST_TIMEOUT)
    try:
        run = run_main(args, layout)
        # a fresh process: the counts are the run's
        run = dataclasses.replace(
            run, dataset=None, run_launches=kops.launch_counts(),
            run_collectives=coll.counts(),
            init_factors=[f.cpu() for f in run.init_factors],
            factors=[f.cpu() for f in run.factors],
            sweep_factors=[[f.cpu() for f in fs]
                           for fs in run.sweep_factors])
        torch.save(run, os.path.join(tmp, f"rank_{rank}.pt"))
        # no rank tears its connections down while another still works
        # repro-lint: disable=SP103 -- the teardown waits for every rank
        coll.barrier()
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()


def launch_mesh(args) -> MeshRun:
    """Spawn the ranks of ``--mesh`` and wait for them; a rank that fails
    fails the run (``torch.multiprocessing`` stops the others and
    re-raises)."""
    import torch.multiprocessing as mp
    layout = mesh_layout(args)
    backend = mesh_backend(args)
    have = (args.force_host_devices if args.device == "cpu"
            else torch.cuda.device_count())
    print(f"mesh={dict(zip(layout.axes, layout.grid))} "
          f"data_axes={layout.data_axes} model_axis={layout.model_axis} "
          f"devices={have} backend={backend}", flush=True)
    if layout.model_size > 1 and args.algorithm in ("als", "ggn") \
            and args.matvec_path in ("fused", "dense"):
        print(f"note: matvec path {args.matvec_path!r} cannot insert the "
              f"inter-half psum(model); using the cost-model choice",
              flush=True)
    if args.device != "cpu":
        # one build before the ranks start, which then load it
        from repro_torch.kernels import _build
        _build.build()
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        mp.start_processes(_rank_main, args=(args, tmp),
                           nprocs=layout.world_size, join=True,
                           start_method="spawn")
        runs = [torch.load(os.path.join(tmp, f"rank_{r}.pt"),
                           weights_only=False)
                for r in range(layout.world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return MeshRun(layout.grid, backend, runs)


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    check_supported(args)
    if args.mesh is not None:
        return launch_mesh(args)
    return run_main(args)


if __name__ == "__main__":
    main()
