"""cg_ms.sweep: device ms a sweep spends in the solvers' conjugate
gradients, from the program's own spans: ALS's ``als/cg`` and GGN's joint
``ggn/pcg`` and per-mode ``ggn/mode_cg``, each timed on the device with
CUDA events (``repro_torch.obs``, live while the profiler records). Only
spans whose host interval lies inside the traced window count; without
such spans (a program that has none) the metric is left out."""
LAYER = "solvers"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "sweep_ms"
NAMES = ("als/cg", "ggn/pcg", "ggn/mode_cg")


def window_spans(view, names):
    """The program's logged spans named in ``names`` whose host interval
    lies inside the traced window; [] where the program logs none."""
    from repro_torch import obs
    spans = getattr(obs.get_registry(), "spans", None)
    if spans is None:
        return []
    lo, hi = view.trace.window
    return [e for e in spans() if e.name in names
            and lo <= e.start_ns and e.end_ns <= hi]


def device_ms_per_sweep(view, names):
    sweeps = view.work.get("sweeps")
    got = window_spans(view, names)
    if not sweeps or not got or any(e.device_s is None for e in got):
        return None
    return sum(e.device_s for e in got) * 1e3 / sweeps


def read(view):
    return device_ms_per_sweep(view, NAMES)
