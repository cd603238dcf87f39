"""cg_matvec_roofline.foldin: the fold-in's Gram matvec, its logical bound
(each call's valid entries with their value and N int32 indices, the
distinct movie and day rows its histories touch, x read and y written for
its users) averaged over the traced calls, over the mean device time of
the kernels that compute it, in percent."""
import re

from tcbench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "users_per_s"
KERNEL = re.compile(r"\bbucket_rows_kernel<\d+, true\b")


def read(view):
    w = view.work
    secs, count = view.trace.matching(KERNEL)
    if not count or not w.get("call_shapes"):
        return None
    bounds = [roofline.pass_bound_s("cg_matvec", m, w["nd"], w["rank"],
                                    rows, users)
              for m, rows, users in w["call_shapes"]]
    return 100.0 * (sum(bounds) / len(bounds)) / (secs / count)
