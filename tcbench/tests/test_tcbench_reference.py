"""The plain references against the port's CPU path at a small size, and
the control that every cell's limits have to fail."""
import json

import pytest

from tcbench import control, spec
from tcbench.tests.small import CELLS, bench, card, execute, small  # noqa


def _on_problem(b, cell, seed, overrides=None):
    """``overrides`` that also draw the cell's problem from ``seed`` where
    its configuration fixes one for every run (``index_seed``), so that
    the control is read on as many problems as seeds."""
    out = {part: dict(keys) for part, keys in (overrides or {}).items()}
    if "index_seed" in spec.resolve(b, cell).config:
        out.setdefault("config", {})["index_seed"] = seed
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(cell):
    r = execute(cell)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"] / 3


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    b = bench()
    limits = spec.resolve(b, cell).traffic["limits"]
    got = control.readings(b, cell, 77, 0.3, True, True, "cpu",
                           _on_problem(b, cell, 77, small(cell)))
    assert any(v > limits[k] for k, v in got["control"].items()), got
    for fault in ("fault_half", "fault_row"):
        if fault in got:
            assert any(v > limits[k] for k, v in got[fault].items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size(card, cell):
    """On the card, three seeds, each a problem of its own: the control
    fails one of the cell's limits on each, and the program passes all."""
    b = bench()
    limits = spec.resolve(b, cell).traffic["limits"]
    for seed in (101, 202, 303):
        got = control.readings(b, cell, seed, 2.0, True, False, "cuda",
                               _on_problem(b, cell, seed))
        assert any(v > limits[k] for k, v in got["control"].items()), \
            json.dumps(got)
        assert all(v <= limits[k] for k, v in got["program"].items()), \
            json.dumps(got)
