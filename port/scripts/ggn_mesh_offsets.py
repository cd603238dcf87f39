#!/usr/bin/env python3
"""Signed offsets of the 2 x 2 gloo mesh's float32 GGN objectives from the
envelope of LOCAL runs, per seed: the diagnosis behind ``chip_smoke.py``
phase 11b's float64 GGN gate (``PERF.md`` §6, the mesh offsets).

    PYTHONPATH=port python port/scripts/ggn_mesh_offsets.py \\
        --loss quadratic --seeds 8 [--dims 200,150,100 --nnz 20000]

For each seed it runs ``launch.complete`` with ``--algorithm ggn`` LOCAL
under ``launch.complete.GGN_SUMMATION_ORDERS`` (bucket granularity 4, 8,
16, the fused and the TTTP + MTTKRP matvec) and once on a 2 x 2 mesh of
gloo ranks (``--force-host-devices 4``), on the CPU by default, and prints
one JSON line: the mesh's objective before and after each iteration, the
LOCAL envelope, and the signed offset (0 inside the envelope; relative to
the nearer end outside it). An offset of one sign across seeds would
point at a fault in the mesh's objective; offsets of both signs at
rounding level point at summation order.

``--exact`` also evaluates every run's objective in float64 (LOCAL, on
the first LOCAL run's tensor) on the factors it held before and after
each iteration, and prints, per run, the float32 objective's relative
error against that (how the run SUMMED its objective) and the exact
objective's offset from LOCAL's exact envelope (how good its FACTORS
are): a mesh whose sum is biased shows the first, a mesh whose solves
are noisier the second.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def offsets(mesh, local):
    """(lo, hi, signed offset) per objective of ``mesh`` against the LOCAL
    runs' objectives ``local``."""
    out = []
    for i, a in enumerate(mesh):
        vals = [r[i] for r in local]
        lo, hi = min(vals), max(vals)
        off = ((a - hi) / abs(hi) if a > hi else
               (a - lo) / abs(lo) if a < lo else 0.0)
        out.append((lo, hi, off))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loss", default="quadratic")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--dims", default="200,150,100")
    ap.add_argument("--nnz", default="20000")
    ap.add_argument("--rank", default="10")
    ap.add_argument("--sweeps", default="2")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--exact", action="store_true",
                    help="evaluate each run's objectives in float64 too")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.launch import complete
    torch.set_num_threads(4)
    for seed in range(args.seeds):
        argv = ["--algorithm", "ggn", "--loss", args.loss, "--dims",
                args.dims, "--nnz", args.nnz, "--rank", args.rank,
                "--cg-iters", "20", "--block-rows", "8", "--sweeps",
                args.sweeps, "--seed", str(seed), "--device", args.device]
        runs = [complete.main(argv + list(o))
                for o in complete.GGN_SUMMATION_ORDERS]
        local = [r.objective for r in runs]
        mr = complete.main(argv + ["--mesh", "2,2"]
                           + (["--force-host-devices", "4"]
                              if args.device == "cpu" else
                              ["--dist-backend", "gloo"])).runs[0]
        mesh = mr.objective
        res = offsets(mesh, local)
        rec = {"seed": seed, "loss": args.loss, "mesh": mesh,
               "lo": [r[0] for r in res], "hi": [r[1] for r in res],
               "off": [r[2] for r in res]}
        if args.exact:
            rec.update(exact(runs, mr, args))
        print(json.dumps(rec), flush=True)


def exact(runs, mr, args):
    """Float64 objectives of each run's factors (see the module
    docstring): ``sum_err`` per run (LOCAL runs first, the mesh last) and
    ``exact_off``, the mesh's exact objectives against LOCAL's exact
    envelope."""
    import torch
    from repro_torch.core import losses
    from repro_torch.core.completion.gcp import gcp_loss
    st = runs[0].dataset.tensor
    st64 = st.astype(torch.float64)
    loss = losses.LOSSES[args.loss]
    lam = float(complete_lam())

    def exact_objs(run):
        return [float(gcp_loss(st64, [f.to(st.values.device,
                                           torch.float64) for f in fs],
                               loss, lam))
                for fs in [run.init_factors] + run.sweep_factors]
    ex = [exact_objs(r) for r in runs] + [exact_objs(mr)]
    sum_err = [[(o - e) / abs(e) for o, e in zip(r.objective, x)]
               for r, x in zip(runs + [mr], ex)]
    return {"exact_mesh": ex[-1],
            "exact_off": [o[2] for o in offsets(ex[-1], ex[:-1])],
            "sum_err": sum_err}


def complete_lam():
    """The CLI's default λ, the one every run here uses."""
    from repro_torch.launch import complete
    return complete.build_parser().parse_args([]).lam


if __name__ == "__main__":
    main()
