"""Tensor-completion CLI, implicit-CG ALS (paper §2.2) on one device:

    python -m repro_torch.launch.complete --algorithm als --dataset function \\
        --dims 200,180,160 --nnz 200000 --rank 10 --sweeps 10 \\
        [--matvec-path fused|tttp_mttkrp] [--device cuda|cpu]

On ``cuda`` every sweep runs the three hand-written kernels: the bucketed
MTTKRP for each right-hand side, the fused CG matvec (or TTTP + bucketed
MTTKRP with ``--matvec-path tttp_mttkrp``) in the CG loop, and TTTP for the
RMSE. ``--init-npz`` loads the tensor (``indices``, ``values``, ``valid``,
``shape``) and the initial ``factor_<d>`` from a file, so a run can start
from the JAX package's arrays; ``--dump-factors x.npz`` writes the final
``factor_<d>``. Each sweep prints ``sweep i  <ms> ms  rmse=<rmse>``, its time
fenced by ``torch.cuda.synchronize()``.

The other algorithms, the Netflix-shaped dataset, checkpointing and
``--mesh`` are refused with a message: they are later slices of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core.completion.als import MATVEC_PATHS, als_sweep
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.tttp import multilinear_values
from repro_torch.data import synthetic
from repro_torch.data.pipeline import CompletionDataset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.complete",
        description="implicit-CG ALS tensor completion on one device")
    ap.add_argument("--dataset", default="function",
                    choices=["function", "netflix"])
    ap.add_argument("--algorithm", default="als",
                    choices=["als", "ccd", "ccd_tttp", "sgd", "gcp", "ggn"])
    ap.add_argument("--dims", default="200,180,160")
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--cg-tol", type=float, default=1e-4,
                    help="batched-CG relative residual tolerance")
    ap.add_argument("--block-rows", type=int, default=8,
                    help="CCSR bucket granularity (output rows per CTA)")
    ap.add_argument("--matvec-path", default="fused", choices=MATVEC_PATHS,
                    help="CG Gram matvec: one fused kernel, or TTTP then "
                         "bucketed MTTKRP")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator behind data and "
                         "initial factors")
    ap.add_argument("--init-npz", default=None, metavar="PATH",
                    help="load the tensor (indices, values, valid, shape) "
                         "and initial factor_<d> from PATH")
    ap.add_argument("--dump-factors", default=None, metavar="PATH.npz",
                    help="write the final factors as factor_0..factor_{N-1}")
    ap.add_argument("--mesh", default=None, help="not ported yet")
    ap.add_argument("--ckpt-dir", default=None, help="not ported yet")
    return ap


def check_supported(args) -> None:
    """Refuse what this slice of the port does not run yet."""
    if args.algorithm != "als":
        raise SystemExit(f"--algorithm {args.algorithm}: only 'als' is "
                         f"ported so far")
    if args.dataset != "function" and args.init_npz is None:
        raise SystemExit(f"--dataset {args.dataset}: only 'function' is "
                         f"ported so far")
    if args.mesh is not None:
        raise SystemExit("--mesh: the port runs on one device so far")
    if args.ckpt_dir is not None:
        raise SystemExit("--ckpt-dir: checkpointing is not ported yet")
    if args.dump_factors is not None and \
            not args.dump_factors.endswith(".npz"):
        raise SystemExit("--dump-factors: only the .npz format is ported "
                         "so far")


@dataclasses.dataclass
class ALSRun:
    """What a run leaves behind: the ingested dataset, the initial and final
    factors, the RMSE before the first sweep, ``(sweep, seconds, rmse)`` per
    sweep and the factors after each sweep."""
    dataset: CompletionDataset
    init_factors: List[torch.Tensor]
    factors: List[torch.Tensor]
    rmse0: float
    history: List[Tuple[int, float, float]]
    sweep_factors: List[List[torch.Tensor]]


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
        raw = synthetic.function_tensor(shape, args.nnz, gen)
        factors = None
    ds = CompletionDataset(raw, gen, block_rows=args.block_rows)
    if factors is None:
        r = args.rank
        factors = [torch.randn(d, r, generator=gen, device=device) / r ** 0.5
                   for d in shape]
    return ds, factors


def run_als(args, ds: CompletionDataset,
            factors: Sequence[torch.Tensor]) -> ALSRun:
    st, omega = ds.tensor, ds.omega
    device = st.device
    fs = list(factors)
    e0 = rmse(st, fs)
    print(f"sweep   -  initial      rmse={e0:.6f}")
    hist, per_sweep = [], []
    for i in range(args.sweeps):
        _sync(device)
        t0 = time.perf_counter()
        fs = als_sweep(st, omega, fs, args.lam, cg_tol=args.cg_tol,
                       cg_iters=args.cg_iters,
                       matvec_path=args.matvec_path,
                       block_rows=ds.block_rows)
        _sync(device)
        dt = time.perf_counter() - t0
        e = rmse(st, fs)
        hist.append((i, dt, e))
        per_sweep.append(fs)
        print(f"sweep {i:3d}  {dt * 1e3:8.1f} ms  rmse={e:.6f}")
    if hist:
        print(f"final rmse={hist[-1][2]:.6f} "
              f"(mean sweep {sum(h[1] for h in hist) / len(hist) * 1e3:.1f}"
              f" ms)")
    return ALSRun(ds, list(factors), fs, e0, hist, per_sweep)


def main(argv: Optional[Sequence[str]] = None) -> ALSRun:
    args = build_parser().parse_args(argv)
    check_supported(args)
    t0 = time.perf_counter()
    ds, factors = load_problem(args)
    _sync(ds.tensor.device)
    st = ds.tensor
    print(f"dataset={args.dataset} shape={st.shape} nnz={st.nnz} "
          f"rank={factors[0].shape[1]} algorithm=als "
          f"matvec_path={args.matvec_path} block_rows={ds.block_rows} "
          f"device={st.device} ingest={time.perf_counter() - t0:.2f} s")
    run = run_als(args, ds, factors)
    if args.dump_factors:
        np.savez(args.dump_factors,
                 **{f"factor_{d}": f.cpu().numpy()
                    for d, f in enumerate(run.factors)})
        print(f"wrote factors to {args.dump_factors}")
    return run


if __name__ == "__main__":
    main()
