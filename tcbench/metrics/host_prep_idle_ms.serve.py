"""host_prep_idle_ms.serve: ms a call in which the device sat idle while
the engine prepared the call's inputs on the host: the traced window's
idle gaps intersected with the program's host spans
``serve/fold_in/pack`` (packing the histories and their upload),
``serve/fold_in/bucket_pattern`` (the bucket view, with its waits for the
device) and ``serve/top_k/pad``, each stamped on the profiler's clock.
Left out where the program has no such span in the window."""
from tcbench import spec

LAYER = "serve engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "users_per_s"
NAMES = ("serve/fold_in/pack", "serve/fold_in/bucket_pattern",
         "serve/top_k/pad")


def idle_ns(gaps, intervals):
    """Nanoseconds of the sorted, disjoint ``gaps`` that the union of
    ``intervals`` covers."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total, i = 0, 0
    for a, b in gaps:
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < b:
            total += min(b, merged[j][1]) - max(a, merged[j][0])
            j += 1
    return total


def idle_ms_per_call(view, names):
    calls = view.work.get("calls")
    got = spec.load_reader("cg_ms.sweep").window_spans(view, names)
    if not calls or not got:
        return None
    spans = [(e.start_ns, e.end_ns) for e in got]
    return idle_ns(view.trace.gaps(), spans) / 1e6 / calls


def read(view):
    return idle_ms_per_call(view, NAMES)
