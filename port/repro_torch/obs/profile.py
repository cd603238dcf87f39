"""Kernel-level roofline profiling: the wiring between the roofline terms
(``repro_torch.launch.roofline``) and the live telemetry layer, the port's
counterpart of the reference's ``obs/profile.py``.

``profile_fn(fn, *args)`` times one callable (CUDA events on the card, the
host clock on the CPU), takes its flop, memory-byte and collective-byte
terms (given as ``terms``, e.g. ``roofline.kernel_terms`` for a CUDA
kernel, or ``roofline.profiler_terms`` of the call), and reports
achieved-against-peak fractions:

* ``frac_peak_compute`` — (flops / measured s) / peak FLOP/s
* ``frac_peak_memory``  — (bytes / measured s) / peak memory B/s
* ``frac_roofline``     — the roofline's least time / measured time (1.0:
  running at the machine model's bound)

The machine constants default to the NVIDIA H100 SXM data sheet (fp32 67
TFLOP/s and FP64 34 TFLOP/s outside the tensor cores, HBM3 3.35 TB/s,
NVLink 450 GB/s each way); ``REPRO_PEAK_FLOPS``, ``REPRO_PEAK_FLOPS_F64``,
``REPRO_HBM_BW`` and ``REPRO_LINK_BW`` override them. The fractions
compare only within one machine model: the report records the constants
used. A CPU run's fractions against the card's
constants describe no device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class Machine:
    peak_flops: float
    hbm_bw: float
    link_bw: float
    # the H100 SXM data sheet's FP64 rate without the tensor cores
    peak_flops_f64: float = 34e12

    @classmethod
    def from_env(cls) -> "Machine":
        from repro_torch.launch import roofline as rl
        return cls(
            peak_flops=float(os.environ.get("REPRO_PEAK_FLOPS",
                                            rl.PEAK_FLOPS)),
            peak_flops_f64=float(os.environ.get("REPRO_PEAK_FLOPS_F64",
                                                rl.PEAK_FLOPS_F64)),
            hbm_bw=float(os.environ.get("REPRO_HBM_BW", rl.HBM_BW)),
            link_bw=float(os.environ.get("REPRO_LINK_BW", rl.LINK_BW)))


def _cuda_outputs(out) -> bool:
    from torch.utils import _pytree as pytree
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in pytree.tree_leaves(out))


def _time_fn(run: Callable[[], Any], iters: int) -> float:
    """Seconds per call of ``run()`` after one warm-up call: the mean of
    ``iters`` back-to-back calls between two CUDA events when the output
    lies on the card, else the best of ``iters`` host-clock calls."""
    iters = max(iters, 1)
    if _cuda_outputs(run()):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def profile_fn(fn: Callable, *args, name: str = "kernel", iters: int = 5,
               machine: Optional[Machine] = None,
               terms: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Time ``fn(*args)``, take its roofline terms (``terms``, default
    ``roofline.profiler_terms(fn, *args)``) and return the
    achieved-against-peak report. With tracing on, also lands the
    measurement in the obs registry (timing ``roofline/<name>``, gauge
    ``roofline/<name>/frac_roofline``) and the JSONL sink."""
    from repro_torch.launch import roofline as rl
    machine = machine or Machine.from_env()
    if terms is None:
        terms = rl.profiler_terms(fn, *args)
    measured_s = _time_fn(lambda: fn(*args), iters)
    flops = float(terms["flops"])
    nbytes = float(terms["bytes"])
    coll = float(terms.get("collective_bytes", 0.0))
    compute_s = flops / machine.peak_flops
    memory_s = nbytes / machine.hbm_bw
    collective_s = coll / machine.link_bw
    bound_s = max(compute_s, memory_s, collective_s)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    out = {
        "name": name,
        "measured_s": measured_s,
        "flops": flops,
        "bytes": nbytes,
        "collective_bytes": coll,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "frac_peak_compute": (flops / measured_s / machine.peak_flops
                              if measured_s else 0.0),
        "frac_peak_memory": (nbytes / measured_s / machine.hbm_bw
                             if measured_s else 0.0),
        "frac_roofline": bound_s / measured_s if measured_s else 0.0,
        "machine": dataclasses.asdict(machine),
    }
    if _trace.enabled():
        reg = _trace.get_registry()
        reg.observe(f"roofline/{name}", measured_s)
        reg.gauge_set(f"roofline/{name}/frac_roofline",
                      out["frac_roofline"])
        _trace.emit_event({"kind": "roofline", **out})
    return out
