"""cg_active_share.foldin: the share of fold-in's CG iterations (a fixed
budget of max(4R, 32) a call) in which some user's row had not yet
converged, in percent, from the program's counters inside the traced
window: each graph replay adds its budget and the graph's own count of
active iterations (read with the rows). Read as
``cg_active_share.sweep`` reads the solvers'."""
from tcbench import spec

LAYER = "serve engine"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "users_per_s"


def read(view):
    return spec.load_reader("cg_active_share.sweep").read(view)
