"""rmse_ms.sweep: device ms a sweep spends in the RMSE read after it
(``launch.complete.rmse``: the model values by TTTP over the COO and the
error's reductions), from the program's device-timed span
``complete/rmse`` inside the traced window; left out where the program has
no such span."""
from tcbench import spec

LAYER = "drivers"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "sweep_ms"
NAMES = ("complete/rmse",)


def read(view):
    return spec.load_reader("cg_ms.sweep").device_ms_per_sweep(view, NAMES)
