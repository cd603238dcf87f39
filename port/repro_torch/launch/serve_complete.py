"""Serving CLI on frozen factors:

    python -m repro_torch.launch.complete --dataset netflix --rank 8 \
        --sweeps 3 --dump-factors /tmp/serve_ckpt
    python -m repro_torch.launch.serve_complete --factors /tmp/serve_ckpt \
        --num-queries 100000 --batch-size 1024 --topk 10 --foldin-users 32

(``--device cpu`` on both to run on the CPU; the card is the default.)
Restores the checkpoint (a checkpoint step directory, written by either
package's ``--dump-factors DIR``, or a legacy ``.npz``) onto ``--device``,
then drives the three endpoints of ``repro_torch.serve.ServeEngine``:

* a load generator streaming ``--num-queries`` random entry-scoring queries
  in ``--batch-size`` batches, reporting QPS and p50/p95/p99 per-batch
  latency;
* ``--topk K`` retrievals over ``--topk-mode`` for ``--topk-users`` sampled
  queries;
* ``--foldin-users`` cold-user fold-ins with ``--foldin-nnz``-entry
  synthetic histories (damped one-row ALS on the frozen factors).

``--verify`` checks the results before any timing is trusted, against
oracles computed on the host in float64 from the factors: served scores
within 1e-6 · max(1, max|s|) of a numpy gather chain, fold-in rows within
1e-4 of an explicit (Gram-forming) one-row ALS solve. The process exits
non-zero otherwise. ``--json`` writes the report.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_complete",
        description="serve frozen CP factors: scoring, top-k, fold-in")
    ap.add_argument("--factors", required=True, metavar="PATH",
                    help="checkpoint directory (step directories) or .npz "
                         "written by launch.complete --dump-factors")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: newest)")
    ap.add_argument("--link", default=None, choices=["identity", "log"],
                    help="prediction link; default: the checkpoint "
                         "metadata's link (identity for .npz)")
    ap.add_argument("--num-queries", type=int, default=10_000)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--score-path", default=None,
                    choices=["all_at_once", "sliced", "pairwise", "dense"],
                    help="a planner TTTP path for scoring; not ported yet "
                         "(default: the TTTP kernel)")
    ap.add_argument("--topk", type=int, default=0, metavar="K",
                    help="also run top-k retrieval (0 disables)")
    ap.add_argument("--topk-mode", type=int, default=1,
                    help="mode retrieved over (the 'items')")
    ap.add_argument("--topk-users", type=int, default=32)
    ap.add_argument("--topk-block", type=int, default=4096,
                    help="item-factor rows per streaming top-k block")
    ap.add_argument("--foldin-users", type=int, default=0, metavar="B",
                    help="fold in B cold users (0 disables)")
    ap.add_argument("--foldin-mode", type=int, default=0,
                    help="mode the cold rows belong to (the 'users')")
    ap.add_argument("--foldin-nnz", type=int, default=16,
                    help="history length per cold user")
    ap.add_argument("--foldin-lam", type=float, default=1e-2,
                    help="fold-in ridge damping λ")
    ap.add_argument("--matvec-path", default=None,
                    choices=["fused", "tttp_mttkrp", "sliced", "dense"],
                    help="fold-in Gram matvec: the fused kernel (default) "
                         "or TTTP then the MTTKRP; sliced and dense are "
                         "planner candidates, not ported yet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="check scores (1e-6) and fold-in rows (1e-4) "
                         "against float64 host oracles; non-zero exit on "
                         "failure")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the load-generator report as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable obs tracing with a JSONL sink")
    ap.add_argument("--device", default="cuda")
    return ap


def _gen_queries(rng, shape, n: int):
    return np.stack([rng.integers(0, s, size=n) for s in shape],
                    axis=1).astype(np.int32)


def _gen_histories(rng, shape, mode: int, users: int, nnz: int):
    others = [d for d in range(len(shape)) if d != mode]
    out = []
    for _ in range(users):
        oidx = np.stack([rng.integers(0, shape[d], size=nnz)
                         for d in others], axis=1).astype(np.int32)
        vals = rng.standard_normal(nnz).astype(np.float32)
        out.append((oidx, vals))
    return out


def host_factors(model):
    """The model's factors on the host in float64: the oracles' input."""
    return [f.cpu().numpy().astype(np.float64) for f in model.factors]


def oracle_scores(fs, idx, link: str) -> np.ndarray:
    """Scores in float64 by a numpy gather chain, the link applied."""
    from repro_torch.core.losses import LOG_CLIP
    prod = fs[0][idx[:, 0]]
    for d in range(1, len(fs)):
        prod = prod * fs[d][idx[:, d]]
    m = prod.sum(axis=1)
    return np.exp(np.clip(m, -LOG_CLIP, LOG_CLIP)) if link == "log" else m


def oracle_foldin(fs, histories, mode: int, lam: float) -> np.ndarray:
    """Fresh one-row ALS rows by explicit Gram assembly, in float64."""
    others = [d for d in range(len(fs)) if d != mode]
    rows = []
    for oidx, vals in histories:
        kr = fs[others[0]][oidx[:, 0]]
        for c, d in enumerate(others[1:], start=1):
            kr = kr * fs[d][oidx[:, c]]
        gram = kr.T @ kr + lam * np.eye(kr.shape[1])
        rows.append(np.linalg.solve(gram, kr.T @ vals.astype(np.float64)))
    return np.stack(rows)


def verify_scores(fs, idx, scores, link: str):
    """(max |served - oracle|, the 1e-6 · max(1, max|s|) limit)."""
    err = float(np.abs(oracle_scores(fs, idx, link) - scores).max())
    return err, 1e-6 * max(1.0, float(np.abs(scores).max()))


def verify_foldin(fs, histories, mode: int, lam: float, rows) -> float:
    """Max |Δ| against the explicit one-row solve."""
    return float(np.abs(oracle_foldin(fs, histories, mode, lam)
                        - rows).max())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch import obs
    from repro_torch.serve import ServeEngine, load_factors, percentiles

    if args.trace:
        obs.enable(jsonl=args.trace)

    device = torch.device(args.device)
    model = load_factors(args.factors, link=args.link, step=args.step,
                         device=device)
    engine = ServeEngine(model, max_batch=args.batch_size,
                         topk_block=args.topk_block,
                         score_path=args.score_path,
                         foldin_lam=args.foldin_lam,
                         foldin_matvec_path=args.matvec_path, device=device)
    meta = {k: model.meta[k] for k in sorted(model.meta) if k != "shape"}
    print(f"restored factors: shape={model.shape} rank={model.rank} "
          f"link={model.link} device={device} meta={meta}")
    report = {"shape": list(model.shape), "rank": model.rank,
              "link": model.link, "batch_size": args.batch_size}
    rng = np.random.default_rng(args.seed)
    failures = []
    fs64 = host_factors(model) if args.verify else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ---- entry-scoring load generator -----------------------------------
    queries = _gen_queries(rng, model.shape, args.num_queries)
    engine.score(queries[:args.batch_size])    # capture outside the clock
    lat = []
    scores = np.empty((args.num_queries,), np.float32)
    sync()
    t_all = time.perf_counter()
    for lo in range(0, args.num_queries, args.batch_size):
        t0 = time.perf_counter()
        out = engine.score(queries[lo:lo + args.batch_size])
        lat.append(time.perf_counter() - t0)
        scores[lo:lo + out.shape[0]] = out
    wall = time.perf_counter() - t_all
    stats = percentiles(lat)
    stats["qps"] = args.num_queries / wall
    report["score"] = stats
    print(f"score: {args.num_queries} queries in {wall*1e3:.1f} ms -> "
          f"{stats['qps']:,.0f} QPS  p50={stats['p50_us']:.0f}us "
          f"p99={stats['p99_us']:.0f}us  (batch {args.batch_size})")

    if args.verify:
        err, lim = verify_scores(fs64, queries, scores, model.link)
        print(f"verify score parity vs the float64 host gather chain: "
              f"max|d|={err:.2e} (limit {lim:.2e})")
        if err > lim:
            failures.append(f"score parity {err:.3e} > {lim:.3e}")

    # ---- top-k retrieval -------------------------------------------------
    if args.topk:
        fixed_modes = [d for d in range(model.ndim) if d != args.topk_mode]
        fixed = {d: rng.integers(0, model.shape[d], size=args.topk_users)
                 for d in fixed_modes}
        engine.top_k(fixed, args.topk_mode, args.topk)   # capture
        sync()
        t0 = time.perf_counter()
        vals, idx = engine.top_k(fixed, args.topk_mode, args.topk)
        dt = time.perf_counter() - t0
        report["topk"] = {"k": args.topk, "users": args.topk_users,
                          "us_per_call": dt * 1e6}
        print(f"top-{args.topk} over mode {args.topk_mode} for "
              f"{args.topk_users} queries: {dt*1e3:.2f} ms/batch; "
              f"sample user0 -> items {idx[0, :5].tolist()} "
              f"scores {np.round(vals[0, :5], 3).tolist()}")

    # ---- cold-user fold-in ----------------------------------------------
    if args.foldin_users:
        hists = _gen_histories(rng, model.shape, args.foldin_mode,
                               args.foldin_users, args.foldin_nnz)
        engine.fold_in(hists, args.foldin_mode)   # capture
        sync()
        t0 = time.perf_counter()
        rows = engine.fold_in(hists, args.foldin_mode)
        dt = time.perf_counter() - t0
        report["foldin"] = {"users": args.foldin_users,
                            "nnz": args.foldin_nnz,
                            "us_per_call": dt * 1e6}
        print(f"fold-in: {args.foldin_users} cold users x "
              f"{args.foldin_nnz} obs in {dt*1e3:.2f} ms "
              f"({dt*1e6/args.foldin_users:.0f} us/user)")
        if args.verify:
            err = verify_foldin(fs64, hists, args.foldin_mode,
                                args.foldin_lam, rows)
            print(f"verify fold-in vs explicit one-row ALS: "
                  f"max|d|={err:.2e}")
            if err > 1e-4:
                failures.append(f"fold-in parity {err:.3e} > 1e-4")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    if failures:
        print("VERIFY FAILED: " + "; ".join(failures))
        sys.exit(1)
    if args.verify:
        print("verify OK")
    return report


if __name__ == "__main__":
    main()
