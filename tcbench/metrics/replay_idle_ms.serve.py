"""replay_idle_ms.serve: ms a call in which the device sat idle while the
engine's host was inside a CUDA graph's replay (``serve/graph/replay``:
the copies into the graph's static buffers and ``graph.replay()``): the
traced window's idle gaps intersected with those spans. A CPU run replays
no graph, so the metric is left out there, as it is where the program has
no such span."""
from tcbench import spec

LAYER = "serve engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "users_per_s"
NAMES = ("serve/graph/replay",)


def read(view):
    return spec.load_reader("host_prep_idle_ms.serve").idle_ms_per_call(
        view, NAMES)
