"""``python -m repro_torch.analysis.spmd`` — the port's SPMD passes.

Runs the passes it is given and exits nonzero when an unsuppressed finding
survives (0 clean, 1 findings, 2 usage):

* ``--sharding``     the sharding interpreter (SP001–SP004): every
  candidate path of every planner family (``--orders``, default 3,4,5;
  local and every distributed variant) runs on ``--device`` under the
  replication-state interpreter, and must leave no partial sum unreduced,
  psum nothing twice, psum no shard and gather no global rows out of a
  row-sharded factor; ``--fault missing-psum|double-psum`` plants the
  seeded defect, which must make it fail;
* ``--collectives``  the collective-matching lint over every port module
  that imports ``torch.distributed`` or ``core.collectives``: divergent
  collective sequences across rank-varying branches, collectives in loops
  on unreduced tensor predicates, collectives outside the ``AxisCtx``'s
  groups or outside ``core/collectives.py`` (SP101–SP103, suppressible
  with a reason; stale SP suppressions surface as JS006);
* ``--footprint``    every tile of the tuner's lattices, in float32,
  bfloat16 and float64, against the card's shared-memory and register
  budgets (SP201); ``--paper-scale`` prices the paper's extents instead,
  ``--budget-mb`` sets the shared-memory budget (as ``REPRO_SMEM_KB``);
* ``--all``          all three.

``--fixture PATH --expect RULE`` analyses one seeded-bug file and exits 0
iff exactly that rule is reported; ``--show-suppressed`` prints the
suppressed findings too.

``--device`` (default ``cuda``, as every entry point of the port): on the
card the kernels are built first, so the footprint reads the compiler's
registers and the sharding sweep runs the kernel routes; the CPU prices
the launch-bounds cap and runs the plain versions.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import List

from repro_torch.analysis.cli import Reporter, _repo_root
from repro_torch.analysis.lint import Finding


def _load_fixture(path: str):
    spec = importlib.util.spec_from_file_location(
        "spmd_fixture_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_fixture(path: str) -> List[Finding]:
    """Analyse one fixture with the detector its declarations select:
    ``run`` + ``IN_STATES`` → the sharding interpreter (``ARGS``,
    ``AXIS_ENV``, optional ``EXPECTED``); ``FAMILY`` + ``TILE`` → the
    footprint certificate; anything else → the collectives lint on the
    file itself."""
    from repro_torch.analysis.spmd import collectives
    from repro_torch.analysis.spmd import footprint
    from repro_torch.analysis.spmd import sharding

    if path.endswith(".py"):
        mod = _load_fixture(path)
        if hasattr(mod, "run") and hasattr(mod, "IN_STATES"):
            return sharding.analyze_fn(
                mod.run, mod.ARGS, mod.IN_STATES, mod.AXIS_ENV,
                expected=getattr(mod, "EXPECTED", None),
                label=os.path.basename(path))
        if hasattr(mod, "FAMILY") and hasattr(mod, "TILE"):
            return footprint.check_fixture(mod)
    return [f for f in collectives.lint_file(path) if not f.suppressed]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.spmd",
        description="SPMD passes of the PyTorch port: collective matching "
                    "and the lattices' shared-memory certificate")
    ap.add_argument("--all", action="store_true",
                    help="run every pass the port has")
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--footprint", action="store_true")
    ap.add_argument("--sharding", action="store_true",
                    help="the sharding interpreter over every candidate "
                         "path (SP001-SP004)")
    ap.add_argument("--root", default=".",
                    help="repo root (default: found from the cwd)")
    ap.add_argument("--device", default="cuda",
                    help="cuda builds the kernels first (registers from "
                         "the build log); cpu prices the launch-bounds cap")
    ap.add_argument("--paper-scale", action="store_true",
                    help="certify --footprint at the paper's extents")
    ap.add_argument("--fixture", default=None, metavar="PATH",
                    help="analyse one seeded-bug fixture file")
    ap.add_argument("--expect", default=None, metavar="RULE",
                    help="with --fixture: exit 0 iff exactly this rule "
                         "is reported")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="advisory findings (stale suppressions) block "
                         "the run")
    ap.add_argument("--orders", default="3,4,5",
                    help="tensor orders of the sharding sweep")
    ap.add_argument("--fault", default=None,
                    choices=("missing-psum", "double-psum"),
                    help="plant a collective bug in the sharding sweep "
                         "(self-test: it must then fail)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="shared-memory budget a CTA of --footprint, set "
                         "through REPRO_SMEM_KB for the pass (default: "
                         "REPRO_SMEM_KB, else the card's opt-in limit)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print suppressed findings too")
    args = ap.parse_args(argv)

    if args.fixture is not None:
        findings = check_fixture(args.fixture)
        for f in findings:
            print(f.format())
        rules = {f.rule for f in findings}
        if args.expect is not None:
            ok = rules == {args.expect}
            print(f"[fixture] {args.fixture}: reported {sorted(rules)}, "
                  f"expected exactly {{{args.expect!r}}}: "
                  f"{'OK' if ok else 'FAILED'}")
            return 0 if ok else 1
        return 0 if not findings else 1

    if args.all:
        args.sharding = args.collectives = args.footprint = True
    if not (args.sharding or args.collectives or args.footprint):
        ap.error("nothing to do: pass --all or at least one pass flag")
    if args.sharding or args.footprint:
        import torch
        if torch.device(args.device).type == "cuda":
            if not torch.cuda.is_available():
                ap.error(f"--device {args.device}: no CUDA card here (pass "
                         f"--device cpu to run the plain versions and "
                         f"price the launch-bounds cap)")
            from repro_torch.kernels import _build
            _build.build()

    root = _repo_root(args.root)
    report = Reporter(args.strict_suppressions, args.show_suppressed)

    if args.sharding:
        from repro_torch.analysis.spmd import sharding
        orders = tuple(int(o) for o in args.orders.split(","))
        sharding.set_fault(args.fault)
        try:
            report("sharding", sharding.run(orders, device=args.device))
        finally:
            sharding.set_fault(None)

    if args.collectives:
        from repro_torch.analysis.spmd import collectives
        report("collectives", collectives.run(root))

    if args.footprint:
        from repro_torch.analysis.spmd import footprint
        saved = os.environ.get("REPRO_SMEM_KB")
        if args.budget_mb is not None:
            os.environ["REPRO_SMEM_KB"] = repr(args.budget_mb * 1024)
        try:
            report("footprint", footprint.run(paper_scale=args.paper_scale))
        finally:
            if saved is None:
                os.environ.pop("REPRO_SMEM_KB", None)
            else:
                os.environ["REPRO_SMEM_KB"] = saved
    return report.verdict()


if __name__ == "__main__":
    sys.exit(main())
