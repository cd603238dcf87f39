"""idle_share.serve: the share of the traced window's wall time in which
no operation ran on the device, in percent."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "users_per_s"


def read(view):
    t = view.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
