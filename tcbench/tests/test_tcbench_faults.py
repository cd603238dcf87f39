"""A run with its timed path broken underneath reads ``correct`` false:
the harness's look for a card is skipped (the run goes to the CPU at a
small size) and the rest of the run is driven as it stands. The cells are
the spec's, picked by the entry they drive: the solver cells (entry
``completion``) and the serving cells (``foldin`` and ``topk``), whose
faults are planted in this process. They run on one chip, so no exchange
between chips can be left out; a cell on another entry brings the tests of
its own faults in files of its own."""
import numpy as np
import pytest
import torch

from tcbench.tests.small import CELLS, ENTRY, bench, execute

SOLVER_CELLS = [c for c in CELLS if ENTRY[c] == "completion"]
# the engine's method that each serving entry calls
SERVE_METHOD = {"foldin": "fold_in", "topk": "top_k"}
SERVING_CELLS = [(c, SERVE_METHOD[ENTRY[c]]) for c in CELLS
                 if ENTRY[c] in SERVE_METHOD]


@pytest.fixture(autouse=True)
def program():
    bench()     # the program on the path, as a run puts it


def _unchanged(monkeypatch):
    import repro_torch.core.completion as comp
    make = comp.make_step

    def make_step(*a, **kw):
        state, step, get = make(*a, **kw)
        return state, (lambda i, s: s), get
    monkeypatch.setattr(comp, "make_step", make_step)


def _half_entries(monkeypatch):
    from repro_torch.core.sparse_tensor import SparseTensor
    from_coo = SparseTensor.from_coo.__func__

    def half(cls, indices, values, shape, *a, **kw):
        return from_coo(cls, indices[::2], values[::2], shape, *a, **kw)
    monkeypatch.setattr(SparseTensor, "from_coo", classmethod(half))


def _altered_row(monkeypatch):
    import repro_torch.core.completion as comp
    make = comp.make_step

    def make_step(*a, **kw):
        state, step, get = make(*a, **kw)

        def altered(i, s):
            s = step(i, s)
            get(s)[0][0] += 1.0
            return s
        return state, altered, get
    monkeypatch.setattr(comp, "make_step", make_step)


@pytest.mark.parametrize("cell", SOLVER_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_entries, _altered_row])
def test_broken_solver_reads_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not execute(cell)["correct"]


def _serve_fault(monkeypatch, kind, method):
    from repro_torch.serve import ServeEngine
    real = getattr(ServeEngine, method)
    last = {}

    def broken(self, *a, **kw):
        out = real(self, *a, **kw)
        if kind == "stale":
            prev = last.get("out")
            last["out"] = out
            return prev if prev is not None else out
        arrays = [np.array(x) for x in (out if isinstance(out, tuple)
                                        else (out,))]
        if kind == "half":
            # half of the batch left out: its answers are never computed
            for x in arrays:
                x[len(x) // 2:] = 0
        else:
            # one answer altered where it is produced
            x = arrays[-1]
            x[0, 0] = x[0, -1] if method == "top_k" else x[0, 0] + 1.0
        return tuple(arrays) if isinstance(out, tuple) else arrays[0]
    monkeypatch.setattr(ServeEngine, method, broken)


@pytest.mark.parametrize("cell,method", SERVING_CELLS)
@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_broken_serving_reads_incorrect(monkeypatch, cell, method, kind):
    _serve_fault(monkeypatch, kind, method)
    torch.manual_seed(0)
    assert not execute(cell, seconds=1.0)["correct"]
