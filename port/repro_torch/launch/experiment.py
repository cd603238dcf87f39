"""Paper-scale experiment harness: named (algorithm × loss × rank × dataset)
sweeps with per-sweep JSON metrics, the paper's study shapes (Figures 6–8):

    python -m repro_torch.launch.experiment --spec netflix-small --out results
    python -m repro_torch.launch.experiment --spec netflix-ci --device cpu
    python -m repro_torch.launch.experiment --list

Each spec streams its dataset through the out-of-core ingest
(``repro_torch.data.streaming`` → ``CompletionDataset.from_stream``) with a
deterministic held-out split, then runs every requested (algorithm, loss)
pair through the solvers and ``RestartableLoop`` checkpointing (the
per-sweep metric history rides in the checkpoint manifest, so an
interrupted experiment resumes with its metrics intact). Output is one JSON
file per spec, with the JAX package's keys: fit time, train and held-out
RMSE, Poisson deviance and the objective per sweep. Each run also records
``launches``, the port's kernel launches in that run.

Algorithm × loss semantics (paper §2): ``ggn`` and ``gcp`` optimize the
requested loss; ``als``/``ccd``/``sgd`` run their quadratic update whatever
the loss, while the metrics report the requested loss: the paper's Fig.-8
comparison of quadratic methods against Poisson methods on count data. The
JSON records ``loss`` (evaluated), ``update_loss`` (optimized) and ``link``
(identity, or log for ggn and gcp on the ``*_log`` losses, where held-out
metrics evaluate exp(model) in rate space).

Everything runs on ``--device`` (``cuda`` unless the caller asks for the
CPU). With a plan cache (``--plan-cache``, ``REPRO_PLAN_CACHE``) the
kernels' launch shapes are tuned on the ingested tensor before the first
run (``planner.tuner.ensure_tuned``, with factors from the port's own
generator, seeded by the spec's seed folded with 97 as the reference folds
its key), the ``plan-cache:`` line is printed and the report gains
``plan_cache``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import zlib
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import losses as LOSS
from repro_torch.core.completion import fold_seed, make_step
from repro_torch.core.completion.gcp import gcp_loss
from repro_torch.data import streaming
from repro_torch.data.pipeline import CompletionDataset
from repro_torch.kernels import ops as kops
from repro_torch.planner import ensure_tuned
from repro_torch.runtime import RestartableLoop

ALGORITHMS = ("als", "ccd", "sgd", "ggn", "gcp")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One named experiment family (a paper figure's study shape)."""
    name: str
    dataset: str                       # "function" | "netflix" | "file"
    shape: Tuple[int, ...]
    nnz: int
    chunk_size: int
    rank: int
    sweeps: int
    algorithms: Tuple[str, ...] = ("als", "ccd", "sgd", "ggn")
    # "poisson_log" is the Poisson loss with log link, the well-posed
    # pairing for unconstrained solvers (identity-link "poisson" is
    # unbounded below for negative models and available via --losses)
    losses: Tuple[str, ...] = ("quadratic", "poisson_log")
    test_fraction: float = 0.1
    lam: float = 1e-4
    lr: float = 1e-3
    sample_rate: float = 0.5
    cg_iters: int = 20
    # initial Levenberg-Marquardt damping for ggn; None = per-loss default
    # (the fast-varying exp curvature of the *_log losses needs a stiff
    # start; the adaptive schedule relaxes it once steps are trusted)
    damping: Optional[float] = None
    seed: int = 0
    zipf_a: float = 1.1
    num_shards: int = 1
    file: Optional[str] = None         # triplet path for dataset="file"
    note: str = ""


SPECS = {s.name: s for s in [
    ExperimentSpec(
        "function-small", "function", (60, 50, 40), nnz=20_000,
        chunk_size=8_192, rank=8, sweeps=6,
        note="scaled-down Fig. 7a model problem"),
    ExperimentSpec(
        "netflix-small", "netflix", (150, 120, 40), nnz=40_000,
        chunk_size=8_192, rank=8, sweeps=6,
        note="scaled-down Fig. 7b/8 netflix-like ratings"),
    ExperimentSpec(
        "netflix-ci", "netflix", (80, 60, 20), nnz=15_000,
        chunk_size=4_096, rank=6, sweeps=4,
        note="nightly-CI shape: every algorithm under both losses"),
    ExperimentSpec(
        "paper-netflix", "netflix", (480_189, 17_770, 2_182),
        nnz=100_477_727, chunk_size=1 << 22, rank=32, sweeps=20,
        num_shards=256, lam=1e-2,
        note="full Netflix scale (paper Fig. 7b); needs a real mesh"),
    ExperimentSpec(
        "paper-function", "function", (16_384, 16_384, 16_384),
        nnz=10_000_000_000, chunk_size=1 << 24, rank=10, sweeps=10,
        num_shards=1024,
        note="paper headline: 10B nonzeros at ~2e-3 density on 256 nodes"),
]}


# ---------------------------------------------------------------------------
# solver construction
# ---------------------------------------------------------------------------

def make_solver(algorithm: str, loss_name: str, st, omega, factors,
                spec: ExperimentSpec, block_rows: int = 8):
    """``(state0, step, get_factors, update_loss_name, link)`` for one
    (algorithm, loss) run; ``step(i, state) -> state`` runs sweep ``i``.

    ``als``/``ccd``/``sgd`` optimize their quadratic update (identity link)
    whatever the evaluated loss; ``ggn``/``gcp`` optimize the requested
    loss, and for ``*_log`` losses the model is a log-rate, so held-out
    evaluation uses the exp (``log``) link."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"choices: {ALGORITHMS}")
    native = algorithm in ("ggn", "gcp")
    link = "log" if native and loss_name.endswith("_log") else "identity"
    update_loss = loss_name if native else "quadratic"
    damping = spec.damping
    if damping is None:
        damping = 10.0 if loss_name.endswith("_log") else 1e-5
    state0, step, get_factors = make_step(
        algorithm, st, omega, factors, lam=spec.lam, block_rows=block_rows,
        loss=update_loss, cg_tol=1e-4, cg_iters=spec.cg_iters,
        matvec_path="fused", lr=spec.lr, sample_rate=spec.sample_rate,
        damping=damping, seed=spec.seed + 1)
    return state0, step, get_factors, update_loss, link


def initial_factors(spec: ExperimentSpec, algorithm: str, loss_name: str,
                    device) -> list:
    """N(0, 1/R) factors from a generator seeded by the spec's seed and the
    crc32 of ``"algorithm/loss"``, as the reference folds its key."""
    run_id = zlib.crc32(f"{algorithm}/{loss_name}".encode()) % (2 ** 31)
    gen = torch.Generator(device=device).manual_seed(
        fold_seed(spec.seed, run_id))
    return [torch.randn(d, spec.rank, generator=gen, device=device)
            / spec.rank ** 0.5 for d in spec.shape]


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def _checked(spec: ExperimentSpec, algorithms, losses):
    algorithms = tuple(algorithms or spec.algorithms)
    losses = tuple(losses or spec.losses)
    for a in algorithms:
        if a not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {a!r}")
    for name in losses:
        if name not in LOSS.LOSSES:
            raise ValueError(f"unknown loss {name!r}")
    return algorithms, losses


def _start_trace(out_dir: str, spec: ExperimentSpec) -> None:
    os.makedirs(out_dir, exist_ok=True)
    obs.enable(jsonl=os.path.join(out_dir, f"trace_{spec.name}.jsonl"))
    obs.get_registry().reset()     # summary scoped to this experiment


def ingest_spec(spec: ExperimentSpec, spool_dir: Optional[str] = None,
                device="cuda") -> Tuple[CompletionDataset, float]:
    """Stream the spec's dataset onto ``device``; returns the dataset and
    the ingest's wall seconds."""
    t0 = time.perf_counter()
    chunks = streaming.make_stream(spec.dataset, spec.seed, spec.shape,
                                   spec.nnz, spec.chunk_size,
                                   path=spec.file, zipf_a=spec.zipf_a)
    # The reference ingests with bucket_modes=() only because its jitted
    # sweeps cannot carry the pattern cache; the port's kernels read the
    # patterns, so every mode's is built here from the streamed counts.
    ds = CompletionDataset.from_stream(
        chunks, spec.shape, num_shards=spec.num_shards,
        test_fraction=spec.test_fraction, spool_dir=spool_dir,
        device=device)
    obs.synchronize(ds.tensor.values)
    return ds, time.perf_counter() - t0


def run_experiment(spec: ExperimentSpec, out_dir: str = "experiments",
                   ckpt_root: Optional[str] = None,
                   algorithms: Optional[Tuple[str, ...]] = None,
                   losses: Optional[Tuple[str, ...]] = None,
                   spool_dir: Optional[str] = None,
                   trace: bool = False,
                   plan_cache: Optional[str] = None,
                   device="cuda") -> dict:
    """Run every (algorithm, loss) pair of ``spec`` and write
    ``<out_dir>/experiment_<name>.json``; returns the report dict.
    ``trace=True`` enables obs tracing with a JSONL event stream at
    ``<out_dir>/trace_<name>.jsonl`` (per-sweep span trees also ride the
    metric history in the checkpoint manifest). ``plan_cache`` (default
    ``REPRO_PLAN_CACHE``) tunes the kernel tiles before the first run."""
    algorithms, losses = _checked(spec, algorithms, losses)
    if trace:
        _start_trace(out_dir, spec)
    ds, seconds = ingest_spec(spec, spool_dir, device)
    return run_on_dataset(spec, ds, seconds, out_dir, ckpt_root, algorithms,
                          losses, trace, plan_cache)


def tune_tiles(spec: ExperimentSpec, ds: CompletionDataset,
               plan_cache: str) -> dict:
    """``ensure_tuned`` on the dataset's tensor with N(0, 1/R) factors drawn
    from a generator seeded by the spec's seed folded with 97; prints the
    ``plan-cache:`` line and returns the summary."""
    st = ds.tensor
    gen = torch.Generator(device=st.device).manual_seed(
        fold_seed(spec.seed, 97))
    factors = [torch.randn(d, spec.rank, generator=gen, device=st.device)
               / spec.rank ** 0.5 for d in spec.shape]
    summary = ensure_tuned(st, factors, omega=ds.omega, cache_path=plan_cache)
    print(f"plan-cache: hits={summary['hits']} "
          f"measured={summary['measured']} "
          f"footprint_pruned={summary['footprint_pruned']} "
          f"winners={summary['winners']}")
    return summary


def run_on_dataset(spec: ExperimentSpec, ds: CompletionDataset,
                   ingest_seconds: float, out_dir: str = "experiments",
                   ckpt_root: Optional[str] = None,
                   algorithms: Optional[Tuple[str, ...]] = None,
                   losses: Optional[Tuple[str, ...]] = None,
                   trace: bool = False,
                   plan_cache: Optional[str] = None) -> dict:
    """:func:`run_experiment` on a dataset the caller ingested from ``spec``
    (``ingest_spec``), on the dataset's device."""
    algorithms, losses = _checked(spec, algorithms, losses)
    plan_cache = plan_cache or os.environ.get("REPRO_PLAN_CACHE")
    if trace and not obs.enabled():
        _start_trace(out_dir, spec)
    st, omega, test_st, stats = ds.tensor, ds.omega, ds.test, ds.stats
    print(f"spec={spec.name} dataset={spec.dataset} shape={spec.shape} "
          f"train_nnz={st.nnz} test_nnz={test_st.nnz if test_st else 0} "
          f"dups_dropped={stats.duplicates_dropped} "
          f"ingest={ingest_seconds:.1f}s device={st.device}")
    report = {
        "spec": {**dataclasses.asdict(spec), "shape": list(spec.shape)},
        "ingest": {
            "seconds": ingest_seconds,
            "nnz": stats.nnz,
            "test_nnz": int(test_st.nnz) if test_st is not None else 0,
            "chunks": stats.chunks,
            "entries_read": stats.entries_read,
            "duplicates_dropped": stats.duplicates_dropped,
            "nnz_rows": list(stats.nnz_rows),
            "shard_nnz": list(stats.shard_nnz),
            "busy_seconds": stats.ingest_seconds,
            "mnnz_per_s": stats.mnnz_per_s,
            "spills": stats.spills,
            "peak_rss_mb": stats.peak_rss_mb,
        },
        "runs": [],
    }
    if plan_cache:
        # before the first sweep: every run launches in the tuned tiles
        tuned = tune_tiles(spec, ds, plan_cache)
        report["plan_cache"] = {
            "path": plan_cache, "hits": tuned["hits"],
            "measured": tuned["measured"],
            "footprint_pruned": tuned["footprint_pruned"],
            "winners": tuned["winners"]}

    for loss_name in losses:
        for algorithm in algorithms:
            factors = initial_factors(spec, algorithm, loss_name, st.device)
            state0, step, get_factors, update_loss, link = make_solver(
                algorithm, loss_name, st, omega, factors, spec,
                ds.block_rows)
            # the objective tracks what the solver minimizes (the quadratic
            # update for als/ccd/sgd); the held-out metrics evaluate the
            # requested loss
            upd_loss = LOSS.LOSSES[update_loss]
            metrics: list = []
            loop = None

            def loop_step(i, state, _m=metrics, _step=step,
                          _get=get_factors, _loss=upd_loss, _link=link,
                          _a=algorithm, _l=loss_name):
                if i > 0 and not _m:
                    # resumed: rebuild the earlier sweeps' metrics from the
                    # checkpoint manifest (RestartableLoop.last_metadata)
                    _m.extend(loop.last_metadata.get("metrics", [])[:i])
                t0 = time.perf_counter()
                with obs.span("sweep", algorithm=_a, loss=_l,
                              sweep=i) as sp:
                    state = _step(i, state)
                    obs.synchronize(state)
                dt = time.perf_counter() - t0
                fs = _get(state)
                train = streaming.heldout_metrics(st, fs, link=_link)
                entry = {"sweep": i, "seconds": dt,
                         "objective": float(gcp_loss(st, fs, _loss,
                                                     spec.lam)),
                         "rmse_train": train["rmse"]}
                if test_st is not None:
                    test = streaming.heldout_metrics(test_st, fs, link=_link)
                    entry["rmse_test"] = test["rmse"]
                    entry["poisson_deviance_test"] = test["poisson_deviance"]
                if sp.record is not None:
                    # the sweep's span tree rides the metric history into
                    # the checkpoint manifest
                    entry["trace"] = sp.record
                _m.append(entry)
                print(f"  [{_a}/{_l}] sweep {i:3d} "
                      f"{dt * 1e3:8.1f} ms  obj={entry['objective']:.5g}  "
                      f"rmse_test={entry.get('rmse_test', float('nan')):.5f}")
                return state

            ckpt_dir = os.path.join(
                ckpt_root or os.path.join(out_dir, "ckpt"),
                spec.name, f"{algorithm}-{loss_name}")
            loop = RestartableLoop(ckpt_dir, loop_step, ckpt_every=5,
                                   metadata_fn=lambda step, _m=metrics:
                                   {"metrics": _m})
            before = kops.launch_counts()
            t0 = time.perf_counter()
            loop.run(state0, spec.sweeps)
            total = time.perf_counter() - t0
            after = kops.launch_counts()
            if not metrics:
                # resumed past the end (experiment already complete): no
                # sweep ran, so rebuild the history from the manifest
                metrics.extend(loop.last_metadata.get("metrics", []))
            report["runs"].append({
                "algorithm": algorithm, "loss": loss_name,
                "update_loss": update_loss, "link": link, "rank": spec.rank,
                "total_seconds": total,
                "sweeps": metrics,
                "final": metrics[-1] if metrics else None,
                "launches": {k: after[k] - before[k] for k in after},
            })

    if trace:
        report["obs"] = obs.get_registry().summary()
        obs.emit_event({"kind": "experiment_summary", "spec": spec.name,
                        "obs": report["obs"]})
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"experiment_{spec.name}.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {out_path} ({len(report['runs'])} runs)")
    if trace:
        obs.disable()
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.experiment",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", default=None, choices=sorted(SPECS),
                    help="named experiment spec")
    ap.add_argument("--list", action="store_true",
                    help="list available specs and exit")
    ap.add_argument("--out", default="experiments", metavar="DIR")
    ap.add_argument("--algorithms", default=None,
                    help="comma list overriding the spec's algorithms")
    ap.add_argument("--losses", default=None,
                    help="comma list overriding the spec's losses")
    ap.add_argument("--sweeps", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--nnz", type=int, default=None)
    ap.add_argument("--num-shards", type=int, default=None)
    ap.add_argument("--spool-dir", default=None,
                    help="spill ingest runs to disk (out-of-core)")
    ap.add_argument("--ckpt-root", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="enable obs tracing; writes trace_<spec>.jsonl "
                         "next to the experiment JSON")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="tune the kernels' launch shapes before the first "
                         "run and keep the winners in PATH (default: "
                         "REPRO_PLAN_CACHE)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list or args.spec is None:
        for name, s in sorted(SPECS.items()):
            print(f"{name:16s} {s.dataset:9s} shape={s.shape} nnz={s.nnz} "
                  f"rank={s.rank} sweeps={s.sweeps} — {s.note}")
        if args.spec is None and not args.list:
            raise SystemExit("pick one with --spec NAME")
        return None
    spec = SPECS[args.spec]
    overrides = {k: getattr(args, k) for k in
                 ("sweeps", "rank", "nnz", "num_shards")
                 if getattr(args, k) is not None}
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return run_experiment(
        spec, out_dir=args.out, ckpt_root=args.ckpt_root,
        algorithms=tuple(args.algorithms.split(",")) if args.algorithms
        else None,
        losses=tuple(args.losses.split(",")) if args.losses else None,
        spool_dir=args.spool_dir, trace=args.trace,
        plan_cache=args.plan_cache, device=args.device)


if __name__ == "__main__":
    main()
