#!/usr/bin/env python3
"""Time one checkout's kernels at the main path's and two small layouts, so
that two checkouts (a commit and its parent) can be compared on one card.

    python port/scripts/compare_trees.py ROOT LABEL [--reps 20]

ROOT is the top of a checkout (where its ``chip_smoke.py`` sits); the
script imports that checkout's ``repro_torch`` and ``chip_smoke``, so the
parent's kernels and wrappers run for the parent. It builds the kernels
(``_build.build``: run the two checkouts' builds before timing), then at
the main path's problem (80 M nonzeros at 20000^3, R = 10, block_rows 8,
seed 0) times TTTP over the COO and over Ω's bucket view, the bucketed
MTTKRP and the fused matvec through ``kernels.ops`` three times each
(CUDA events over ``--reps`` back-to-back calls), and at the fold-in and
``netflix-small`` layouts of ``chip_smoke.py`` phase 10 the bucketed pair
eagerly and in one CUDA graph (``chip_smoke.time_ms`` and ``graph_ms``,
10 × ``--reps`` calls). Each bucketed kernel is also launched twice on the
same inputs, and ``*_equal`` says whether the two outputs are the same
bits (``*_maxdiff`` how far apart they are at 80 M). Prints one JSON line,
``TREE {...}``, times in ms. Run the checkouts alternately in one chip
call (parent, change, change, parent) and compare within that call.
"""
import json
import os
import sys


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "port"))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.tile import DEFAULT_TILE
    from repro_torch.launch import complete

    _build.lib()
    out = {"label": args.label}
    problem = complete.build_parser().parse_args(
        ["--dataset", "function", "--dims", ",".join(map(str, cs.DIMS)),
         "--nnz", str(cs.NNZ), "--rank", str(cs.RANK), "--block-rows",
         str(cs.BLOCK_ROWS), "--seed", str(cs.SEED), "--device", "cuda"])
    ds, fs = complete.load_problem(problem)
    st, om = ds.tensor, ds.omega
    ones = st.with_values(torch.ones_like(st.values))
    bk = st.row_buckets(0, cs.BLOCK_ROWS)
    bo = om.row_buckets(0, cs.BLOCK_ROWS)
    others = [None] + list(fs[1:])
    calls = {"tttp": lambda: kops.tttp_values(ones, fs),
             "tttp_bucket_view": lambda: kops.tttp_bucket_values(bo, fs),
             "mttkrp": lambda: kops.mttkrp_bucketed(bk, others),
             "cg_matvec": lambda: kops.cg_matvec_bucketed(bo, fs, fs[0])}
    for name, fn in calls.items():
        out[name] = [cs.time_ms(torch, fn, args.reps) for _ in range(3)]
        if name in ("mttkrp", "cg_matvec"):
            a, b = fn(), fn()
            out[f"{name}_equal"] = bool(torch.equal(a, b))
            out[f"{name}_maxdiff"] = float((a - b).abs().max())
    del ds, st, om, ones, bk, bo, calls
    torch.cuda.empty_cache()
    for name, make in (("foldin", cs.foldin_layout),
                       ("skewed", cs.skewed_layout)):
        lay = make(torch)
        for family in ("mttkrp", "cg_matvec"):
            fn = lay.calls[family][0]

            def run():
                return fn(DEFAULT_TILE)

            key = f"{name}_{family}"
            out[f"{key}_eager"] = [cs.time_ms(torch, run, 10 * args.reps)
                                   for _ in range(3)]
            out[f"{key}_graph"] = [cs.graph_ms(torch, run, 10 * args.reps)
                                   for _ in range(3)]
            out[f"{key}_equal"] = bool(torch.equal(run(), run()))
        del lay
        torch.cuda.empty_cache()
    print("TREE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
