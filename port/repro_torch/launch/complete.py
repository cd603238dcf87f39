"""Tensor-completion CLI on one device:

    python -m repro_torch.launch.complete --algorithm als --dataset function \\
        --dims 200,180,160 --nnz 200000 --rank 10 --sweeps 10 \\
        [--loss quadratic] [--matvec-path fused|tttp_mttkrp|auto|sliced|dense] \\
        [--ckpt-dir DIR] [--dump-factors DIR|PATH.npz] [--device cuda|cpu]

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

``--mesh`` (distribution, ``ROADMAP.md`` Queue A item 4) and
``--plan-cache`` (the kernel-tile tuner, item 2) are refused with a message.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.core import losses as LOSS
from repro_torch.core.completion import GGNState, make_step
from repro_torch.core.completion.als import MATVEC_PATHS
from repro_torch.core.completion.gcp import gcp_loss
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values
from repro_torch.data import synthetic
from repro_torch.data.pipeline import CompletionDataset
from repro_torch.kernels import ops as kops
from repro_torch.planner import PlannerConfig, set_default_config
from repro_torch.runtime import RestartableLoop

ALGORITHMS = ("als", "ccd", "ccd_tttp", "sgd", "gcp", "ggn")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.complete",
        description="tensor completion on one device")
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
    ap.add_argument("--mesh", default=None,
                    help="refused: distribution is not ported yet")
    ap.add_argument("--plan-cache", default=None,
                    help="refused: the kernel-tile tuner is not ported yet")
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
        raise SystemExit("--mesh: the port runs on one device so far "
                         "(distribution, ROADMAP.md Queue A item 4)")
    if args.plan_cache is not None:
        raise SystemExit("--plan-cache: the kernel-tile tuner is not ported "
                         "yet (ROADMAP.md Queue A item 2)")


@dataclasses.dataclass
class Run:
    """What a run leaves behind: the ingested dataset, the initial and final
    factors, the RMSE before the first sweep, ``(sweep, seconds, rmse)`` per
    sweep, the factors after each sweep and each sweep's kernel launches.
    For ``gcp`` and ``ggn`` also the objective, before the first sweep and
    after each, and for ``ggn`` the damping after each sweep. A run resumed
    from ``--ckpt-dir`` records only the sweeps it ran."""
    dataset: CompletionDataset
    init_factors: List[torch.Tensor]
    factors: List[torch.Tensor]
    rmse0: float
    history: List[Tuple[int, float, float]]
    sweep_factors: List[List[torch.Tensor]]
    sweep_launches: List[Dict[str, int]]
    objective: List[float]
    damping: List[float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rmse(st: SparseTensor, factors: Sequence[torch.Tensor]) -> float:
    model = multilinear_values(st, factors)
    d = (st.values - model) * st.mask
    n = max(int(st.mask.sum()), 1)
    return float(torch.sqrt((d * d).sum() / n))


def load_problem(args) -> Tuple[CompletionDataset, List[torch.Tensor]]:
    """Make (or load) the tensor, ingest it and draw the initial factors."""
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
    ds = CompletionDataset(raw, gen, block_rows=args.block_rows)
    if factors is None:
        r = args.rank
        factors = [torch.randn(d, r, generator=gen, device=device) / r ** 0.5
                   for d in shape]
    return ds, factors


def run_solver(args, ds: CompletionDataset,
               factors: Sequence[torch.Tensor]) -> Run:
    """``args.sweeps`` sweeps of ``args.algorithm`` from ``factors``,
    through ``RestartableLoop`` when ``args.ckpt_dir`` is set."""
    st = ds.tensor
    device = st.device
    loss = LOSS.LOSSES[args.loss]
    with_objective = args.algorithm in ("gcp", "ggn")
    state0, step, get_factors = make_step(
        args.algorithm, st, ds.omega, factors, lam=args.lam,
        block_rows=ds.block_rows, loss=args.loss, cg_tol=args.cg_tol,
        cg_iters=args.cg_iters, matvec_path=args.matvec_path, lr=args.lr,
        sample_rate=args.sample_rate, damping=args.damping, seed=args.seed)
    e0 = rmse(st, factors)
    objective = []
    line = f"sweep   -  initial      rmse={e0:.6f}"
    if with_objective:
        objective.append(float(gcp_loss(st, factors, loss, args.lam)))
        line += f"  objective={objective[0]:.6g}"
    print(line)
    hist, per_sweep, launches, damping = [], [], [], []

    def loop_step(i, state):
        _sync(device)
        before = kops.launch_counts()
        t0 = time.perf_counter()
        state = step(i, state)
        _sync(device)
        dt = time.perf_counter() - t0
        after = kops.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        fs = get_factors(state)
        e = rmse(st, fs)
        hist.append((i, dt, e))
        per_sweep.append(fs)
        line = f"sweep {i:3d}  {dt * 1e3:8.1f} ms  rmse={e:.6f}"
        if with_objective:
            objective.append(float(gcp_loss(st, fs, loss, args.lam)))
            line += f"  objective={objective[-1]:.6g}"
        if isinstance(state, GGNState):
            damping.append(float(state.damping))
            line += f"  damping={damping[-1]:.3g}"
        print(line)
        return state

    if args.ckpt_dir:
        state = RestartableLoop(args.ckpt_dir, loop_step, ckpt_every=5).run(
            state0, args.sweeps)
    else:
        state = state0
        for i in range(args.sweeps):
            state = loop_step(i, state)
    final = get_factors(state)
    if hist:
        print(f"final rmse={hist[-1][2]:.6f} "
              f"(mean sweep {sum(h[1] for h in hist) / len(hist) * 1e3:.1f}"
              f" ms)")
    elif args.ckpt_dir:
        print(f"final rmse={rmse(st, final):.6f} (all {args.sweeps} sweeps "
              f"restored from {args.ckpt_dir})")
    return Run(ds, list(factors), final, e0, hist, per_sweep,
               launches, objective, damping)


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
                            "nnz": int(st.nnz), "sweeps": args.sweeps})
    print(f"wrote factors to {args.dump_factors}")


def main(argv: Optional[Sequence[str]] = None) -> Run:
    args = build_parser().parse_args(argv)
    check_supported(args)
    # ingest (CompletionDataset) and planner dispatch read one bucket view
    set_default_config(PlannerConfig(block_rows=args.block_rows))
    t0 = time.perf_counter()
    ds, factors = load_problem(args)
    _sync(ds.tensor.device)
    st = ds.tensor
    print(f"dataset={args.dataset} shape={st.shape} nnz={st.nnz} "
          f"rank={factors[0].shape[1]} algorithm={args.algorithm} "
          f"loss={args.loss} matvec_path={args.matvec_path} "
          f"block_rows={ds.block_rows} "
          f"device={st.device} ingest={time.perf_counter() - t0:.2f} s")
    run = run_solver(args, ds, factors)
    if args.dump_factors:
        dump_factors(args, run)
    return run


if __name__ == "__main__":
    main()
