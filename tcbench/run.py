"""Run one cell of the benchmark on the card and print its result line.

    python3 -m tcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The spec and every file it names are checked
first (a mistake is refused with one message, exit 2); a checkout without
the program (``port/repro_torch``) is refused too. Without a CUDA card, or
with fewer cards than the cell asks for, the run stops with exit 3 and no
result: nothing falls back to the CPU.

Then: the cell's set-up (inputs from the seed, the program's set-up and
warm-up; ``setup_s`` counts from the process's start to the end of it), a
window of ``--seconds`` of timed work (under the profiler with ``--trace
1``), the peak device memory, the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), the program's state freed, and the
comparison with the plain reference. The numbers compared and their limits
are the last lines on standard error and the last key of the result, the
JSON object on the last line of standard output. A run whose process holds
JAX, the JAX package or ``benchmarks`` once the window has closed prints no
result and exits 4.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

from tcbench import ROOT, spec  # noqa: E402
from tcbench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# build and kernel caches at fixed places inside the checkout
CACHE_DIR = ROOT / ".tcbench_cache"


def since_process_start() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot), else since this module was imported."""
    floor = time.perf_counter() - _T_IMPORT
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(time.clock_gettime(time.CLOCK_BOOTTIME) - started, floor)
    except (OSError, ValueError, IndexError):
        return floor


def forbidden_modules() -> Sequence[str]:
    """Top-level names of ``sys.modules`` that the run may not hold, each
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m tcbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"tcbench: {msg}", file=sys.stderr, flush=True)


def use_program() -> None:
    """Put the port on the path (never the JAX package's ``src/``), and
    its caches inside the checkout."""
    if not (ROOT / "port" / "repro_torch" / "__init__.py").is_file():
        raise spec.Refusal("the program (port/repro_torch) is not in this "
                           "checkout")
    port = str(ROOT / "port")
    if port not in sys.path:
        sys.path.insert(0, port)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE_DIR / sub)


def context(cell: types.SimpleNamespace, seed: int, device: str,
            tracer: Tracer) -> types.SimpleNamespace:
    """What an entry is built from: the cell's files, the seed, the device
    and the tracer."""
    return types.SimpleNamespace(name=cell.name, config=cell.config,
                                 traffic=cell.traffic, seed=seed,
                                 device=device, tracer=tracer,
                                 reference=cell.reference)


def window(entry, seconds: float) -> float:
    """Whole steps of ``entry`` until ``seconds`` have passed; returns the
    window's length."""
    t0 = time.perf_counter()
    while True:
        entry.window_step()
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0


def execute(bench: Dict, cell: types.SimpleNamespace, seed: int,
            seconds: float, trace: bool, device: str,
            overrides: Optional[Dict] = None) -> Dict:
    """One run of ``cell``; returns the result object (``checks`` last).
    ``overrides`` replaces configuration or traffic keys (CPU tests at a
    small size)."""
    import torch
    for part, keys in (overrides or {}).items():
        getattr(cell, part).update(keys)
    tracer = Tracer(trace)
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    entry = cell.entry.Entry(context(cell, seed, device, tracer))
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = since_process_start()
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")

    tracer.start()
    window_s = window(entry, seconds)
    traced = tracer.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window {window_s:.3f} s, {entry.attempted} attempted, "
        f"{entry.failed} failed")

    names = spec.units(bench)
    e2e = entry.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    metrics = {}
    if traced is None:
        for m in spec.e2e_metrics(bench, cell.name):
            metrics[m] = {"value": e2e[m], "unit": names[m]}
    else:
        view = types.SimpleNamespace(trace=traced, work=entry.work(),
                                     config=cell.config, traffic=cell.traffic)
        for m in spec.per_layer_metrics(bench, cell.name):
            value = spec.load_reader(m).read(view)
            if value is not None:
                metrics[m] = {"value": value, "unit": names[m]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s

    entry.release()
    t1 = time.perf_counter()
    numbers = entry.numbers(entry.answers())
    log(f"reference {time.perf_counter() - t1:.3f} s")
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = entry.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": entry.attempted,
              "failed": entry.failed, "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse(argv)
    try:
        bench = spec.load()
        cell = spec.resolve(bench, args.workload)
        use_program()
    except spec.Refusal as e:
        log(f"refused: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA card(s), this machine "
            f"has {have}; no result")
        return 3
    result = execute(bench, cell, args.seed, args.seconds,
                     bool(args.trace), "cuda")
    held = forbidden_modules()
    if held:
        log(f"the run holds {held} once the window has closed; no result")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
