"""launches_per_batch.serve: kernel launches on the device per call
(copies and fills left out), from the profiler's trace: what the engine's
CUDA graphs and its host-side work cost in launches."""
LAYER = "serve engine"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "users_per_s"


def read(view):
    calls = view.work.get("calls")
    if not calls:
        return None
    return view.trace.launches() / calls
