"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed the numbers that the program's answers give against
the float64 reference (the lower readings), and for the control seeds the
numbers of the reference put in the program's place at the control's
precision (bf16 operands over float32 sums; the upper readings). With
``--faults``, the solver cells also read two faults planted in the
reference put in the program's place: half of the entries left out, and
one factor row altered in every compared sweep; and a witness, the
reference itself in float32, which shows how far float32 rounding alone
moves the solver's iterates.

    python3 -m tcbench.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults] [--seconds 2]

One JSON line a seed on standard output. The serving cells run a window of
``--seconds`` at the cell's own load to have answers to compare; the
solver cells' answers are their set-up's first sweeps.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from tcbench import run, spec
from tcbench.reference import common as C


def readings(bench: Dict, name: str, seed: int, seconds: float,
             control: bool, faults: bool, device: str = "cuda",
             overrides: Optional[Dict] = None) -> Dict:
    cell = spec.resolve(bench, name)
    for part, keys in (overrides or {}).items():
        getattr(cell, part).update(keys)
    entry = cell.entry.Entry(run.context(cell, seed, device,
                                         run.Tracer(False)))
    t0 = time.perf_counter()
    entry.setup()
    if "compare_sweeps" not in cell.traffic:
        run.window(entry, seconds)
    entry.release()
    out = {"workload": name, "seed": seed,
           "program": entry.numbers(entry.answers()),
           "program_s": time.perf_counter() - t0}
    want = copy.deepcopy(getattr(entry, "_want", None))
    if isinstance(want, list):
        # the program's choices that the reference took at a tie
        out["notes"] = [w.get("notes", []) for w in want]
    if control:
        t1 = time.perf_counter()
        out["control"] = entry.numbers(entry.answers(C.CONTROL))
        out["control_s"] = time.perf_counter() - t1
    if faults and "compare_sweeps" in cell.traffic:
        out["fault_half"] = entry.numbers(
            entry.answers(C.REFERENCE, keep=slice(0, None, 2)))
        altered = want
        for sweep in altered:
            sweep["factors"][0][0] = 0.0
        out["fault_row"] = entry.numbers(altered)
        out["witness_float32"] = entry.numbers(
            entry.answers(C.Precision(torch.float32)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tcbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    try:
        bench = spec.load()
        spec.resolve(bench, args.workload)
        run.use_program()
    except spec.Refusal as e:
        print(f"tcbench.control: refused: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tcbench.control: no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        print(json.dumps(readings(bench, args.workload, seed, args.seconds,
                                  seed in ctrl, args.faults and seed in ctrl)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
