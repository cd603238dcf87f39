"""cg_matvec_roofline.sweep: the fused Gram matvec's logical bound (valid
entries with their value and N int32 indices, the other modes' distinct
factor rows, x read and y written) over the mean device time of the kernels
that compute it, in percent."""
import re

from tcbench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "sweep_ms"
# the bucketed body with FUSED = true: bucket_rows_kernel<RMAX, true, ...>
KERNEL = re.compile(r"\bbucket_rows_kernel<\d+, true\b")


def read(view):
    w = view.work
    secs, count = view.trace.matching(KERNEL)
    if not count:
        return None
    rows, nd = w["rows"], len(w["rows"])
    bound = sum(roofline.pass_bound_s("cg_matvec", w["nnz"], nd, w["rank"],
                                      sum(rows) - rows[d], rows[d])
                for d in range(nd)) / nd
    return 100.0 * bound / (secs / count)
