"""tttp_roofline.sweep: TTTP's logical bound (valid entries with their
value and N int32 indices read once, every mode's distinct factor rows, one
value written an entry) over the mean device time of its kernel, in
percent."""
import re

from tcbench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "sweep_ms"
KERNEL = re.compile(r"\btttp_kernel<")


def read(view):
    w = view.work
    secs, count = view.trace.matching(KERNEL)
    if not count:
        return None
    rows = w["rows"]
    bound = roofline.pass_bound_s("tttp", w["nnz"], len(rows), w["rank"],
                                  sum(rows), 0)
    return 100.0 * bound / (secs / count)
