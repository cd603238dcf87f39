"""sweep_mfu: the least time the chip needs for a sweep's logical work
over the measured sweep time, in percent of the chip's peak. The work is
every pass over the nonzeros that the solver prescribes at the traffic's
settings (the traffic file's ``passes``), not what the program launched,
so a change that fuses or drops a kernel still sees this bound."""
from tcbench import roofline

LAYER = "solvers"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "sweep_ms"


def read(view):
    w = view.work
    if not w.get("sweeps"):
        return None
    bound = roofline.sweep_bound_s(w["passes"], w["nnz"], w["rank"],
                                   w["rows"])
    return 100.0 * bound * w["sweeps"] / view.trace.window_s
