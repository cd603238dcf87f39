"""``python -m repro_torch.analysis.spmd`` — the port's SPMD passes.

Runs the passes it has and exits nonzero when an unsuppressed finding
survives (0 clean, 1 findings, 2 usage):

* ``--collectives``  the collective-matching lint over every port module
  that imports ``torch.distributed`` or ``core.collectives``: divergent
  collective sequences across rank-varying branches, collectives in loops
  on unreduced tensor predicates, collectives outside the ``AxisCtx``'s
  groups or outside ``core/collectives.py`` (SP101–SP103, suppressible
  with a reason; stale SP suppressions surface as JS006);
* ``--footprint``    every tile of the tuner's lattices, in float32 and
  bfloat16, against the card's shared-memory and register budgets
  (SP201); ``--paper-scale`` prices the paper's extents instead;
* ``--all``          both.

``--sharding`` (the JAX package's sharding interpreter, SP001–SP004) is
refused: its torch counterpart, an interpreter over the program's
collectives, is ``ROADMAP.md`` Queue A item 6. ``--fixture PATH --expect RULE`` analyses one seeded-bug file and
exits 0 iff exactly that rule is reported.

``--device`` (default ``cuda``, as every entry point of the port): on the
card the kernels are built first, so the footprint reads the compiler's
registers; the CPU prices the launch-bounds cap.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import List

from repro_torch.analysis.cli import Reporter, _repo_root
from repro_torch.analysis.lint import Finding

SHARDING_REFUSAL = (
    "the sharding interpreter (SP001-SP004, the reference's abstract "
    "interpreter over jaxprs) is not ported: its torch counterpart, an "
    "interpreter over the program's collectives, is ROADMAP.md Queue A "
    "item 6")


def _load_fixture(path: str):
    spec = importlib.util.spec_from_file_location(
        "spmd_fixture_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_fixture(path: str) -> List[Finding]:
    """Analyse one fixture with the detector its declarations select:
    ``FAMILY`` + ``TILE`` → the footprint certificate; ``IN_STATES`` (a
    sharding fixture) → refused; anything else → the collectives lint on
    the file itself."""
    from repro_torch.analysis.spmd import collectives
    from repro_torch.analysis.spmd import footprint

    if path.endswith(".py"):
        mod = _load_fixture(path)
        if hasattr(mod, "IN_STATES"):
            return [Finding(path, 0, 0, "SP000", SHARDING_REFUSAL)]
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
                    help="refused: " + SHARDING_REFUSAL)
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
    args = ap.parse_args(argv)

    if args.sharding:
        ap.error(SHARDING_REFUSAL)

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
        args.collectives = args.footprint = True
    if not (args.collectives or args.footprint):
        ap.error("nothing to do: pass --all or at least one pass flag")

    root = _repo_root(args.root)
    report = Reporter(args.strict_suppressions)

    if args.collectives:
        from repro_torch.analysis.spmd import collectives
        report("collectives", collectives.run(root))

    if args.footprint:
        import torch
        if torch.device(args.device).type == "cuda":
            if not torch.cuda.is_available():
                ap.error(f"--device {args.device}: no CUDA card here (pass "
                         f"--device cpu to price the launch-bounds cap)")
            from repro_torch.kernels import _build
            _build.build()
        from repro_torch.analysis.spmd import footprint
        report("footprint", footprint.run(paper_scale=args.paper_scale))
    print(f"[sharding] not run: {SHARDING_REFUSAL}")
    return report.verdict()


if __name__ == "__main__":
    sys.exit(main())
