"""aten_ms.sweep: device ms a sweep spends outside the port's own CUDA
kernels (elementwise work, CG vector work, bucket-value gathers,
reductions, fills, copies), from the profiler's trace."""
import re

LAYER = "solvers"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "sweep_ms"
PORT_KERNELS = re.compile(r"\b(tttp_kernel|bucket_rows_kernel)<")


def read(view):
    sweeps = view.work.get("sweeps")
    if not sweeps:
        return None
    other = sum(s for name, (s, _) in view.trace.by_name().items()
                if not PORT_KERNELS.search(name))
    return other * 1e3 / sweeps
