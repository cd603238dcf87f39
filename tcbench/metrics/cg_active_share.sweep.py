"""cg_active_share.sweep: the share of the CG iterations the solvers ran
in which some row had not yet converged, in percent: the program's
counters ``cg/active_iterations`` (counted on the device, folded in when
the registry is read) over ``cg/iterations`` (the fixed budgets run),
summed over the bumps stamped inside the traced window. Left out where the
program keeps no such counters."""
LAYER = "solvers"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "sweep_ms"


def read(view):
    from repro_torch import obs
    log = getattr(obs.get_registry(), "counter_log", None)
    if log is None:
        return None
    lo, hi = view.trace.window
    total = {"cg/iterations": 0.0, "cg/active_iterations": 0.0}
    for name, t_ns, value in log("cg/"):
        if name in total and lo <= t_ns <= hi:
            total[name] += value
    if not total["cg/iterations"]:
        return None
    return 100.0 * total["cg/active_iterations"] / total["cg/iterations"]
