"""``python -m repro_torch.analysis`` — the port's static gates.

Runs any combination of the four passes and exits nonzero when any
unsuppressed finding survives (the JAX package's ``repro-lint`` exit
codes: 0 clean, 1 findings, 2 usage):

* ``--lint``      the port's lint over ``port/repro_torch`` (JS000–JS006)
* ``--contracts`` the planner contract sweep (7 IR families × candidate
  paths × local and distributed, cost invariants, cache keys; CT001–CT003)
  on ``--device`` (default ``cuda``, as every entry point of the port;
  the CPU runs the kernels' plain versions)
* ``--pytrees``   pytree registrations (PT001) and cache-key aliasing
  (PT002)
* ``--deadcode``  import-graph reachability (unreachable modules are
  findings, DC001; test-only modules are reported)
* ``--all``       everything above

``--corrupt PATH`` is the tripwire: it distorts one candidate path's output
in the contract sweep, which must then fail. ``--pytree-module MOD`` runs
the pytree pass over one more importable module too (its pytree
registrations, PT001, and the cache-key types it declares in
``CACHE_KEY_GRIDS``, PT002); ``--show-suppressed`` prints the suppressed
findings.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analysis.lint import Finding


def _repo_root(start: str) -> str:
    """Nearest ancestor holding ``port/repro_torch`` (runs from anywhere in
    the checkout)."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, "port", "repro_torch")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


class Reporter:
    """Prints findings per pass and counts the blocking ones. Advisory
    findings (JS006) block only under ``strict``; suppressed ones are
    counted, and printed under ``show_suppressed``."""

    def __init__(self, strict: bool, show_suppressed: bool = False):
        self.strict = strict
        self.show_suppressed = show_suppressed
        self.failures = 0

    def __call__(self, pass_name: str, findings: List[Finding]) -> None:
        blocking, advisory, suppressed = [], [], []
        for f in findings:
            if f.suppressed:
                suppressed.append(f)
            elif f.advisory and not self.strict:
                advisory.append(f)
            else:
                blocking.append(f)
        for f in blocking:
            print(f.format())
        for f in advisory:
            print("warning: " + f.format())
        if self.show_suppressed:
            for f in suppressed:
                print("suppressed: " + f.format())
        self.failures += len(blocking)
        notes = []
        if advisory:
            notes.append(f"{len(advisory)} advisory")
        if suppressed:
            notes.append(f"{len(suppressed)} suppressed")
        note = (", " + ", ".join(notes)) if notes else ""
        print(f"[{pass_name}] {len(blocking)} finding(s){note}", flush=True)

    def verdict(self) -> int:
        print("OK" if self.failures == 0
              else f"FAILED: {self.failures} finding(s)")
        return 0 if self.failures == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static gates of the PyTorch port")
    ap.add_argument("--all", action="store_true", help="run every pass")
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--contracts", action="store_true")
    ap.add_argument("--pytrees", action="store_true")
    ap.add_argument("--deadcode", action="store_true")
    ap.add_argument("--root", default=".",
                    help="repo root (default: found from the cwd)")
    ap.add_argument("--orders", default="3,4,5",
                    help="tensor orders of the contract sweep")
    ap.add_argument("--device", default="cuda",
                    help="where the contract sweep runs its paths")
    ap.add_argument("--corrupt", default=None, metavar="PATH",
                    help="distort this candidate path's output (self-test: "
                         "the sweep must then fail)")
    ap.add_argument("--pytree-module", default=None, metavar="MOD",
                    help="also run the pytree pass over this importable "
                         "module (CACHE_KEY_GRIDS for PT002)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print suppressed findings too")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="advisory findings (JS006 stale suppressions) "
                         "block the run")
    args = ap.parse_args(argv)

    if args.all:
        args.lint = args.contracts = args.pytrees = args.deadcode = True
    if not (args.lint or args.contracts or args.pytrees or args.deadcode):
        ap.error("nothing to do: pass --all or at least one pass flag")
    if args.contracts:
        import torch
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            ap.error(f"--device {args.device}: no CUDA card here (pass "
                     f"--device cpu to sweep the plain versions)")

    root = _repo_root(args.root)
    report = Reporter(args.strict_suppressions, args.show_suppressed)

    if args.lint:
        from repro_torch.analysis import lint
        report("lint", lint.lint_paths([os.path.join(root, "port",
                                                     "repro_torch")]))

    if args.contracts:
        from repro_torch.analysis import contracts
        orders = tuple(int(o) for o in args.orders.split(","))
        contracts.set_corrupt(args.corrupt)
        try:
            report("contracts", contracts.run(orders, device=args.device))
        finally:
            contracts.set_corrupt(None)

    if args.pytrees:
        from repro_torch.analysis import pytree_check
        report("pytrees", pytree_check.run(root, args.pytree_module))

    if args.deadcode:
        from repro_torch.analysis import deadcode
        rep = deadcode.analyze(root)
        print(rep.format())
        report("deadcode", [
            Finding("imports", 0, 0, "DC001",
                    f"module {m} is unreachable from the product and test "
                    f"roots — delete it or wire it in")
            for m in sorted(rep.unreachable)])

    return report.verdict()


if __name__ == "__main__":
    sys.exit(main())
