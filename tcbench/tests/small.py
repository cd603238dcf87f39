"""Sizes at which the cells run on the CPU in the tests: the cells' own
traffic and settings, on the smaller extents that each cell's traffic file
gives under ``small`` (``{"config": {...}, "traffic": {...}}``, keys of the
cell's configuration and traffic file replaced). The run never reads
``small``; a new cell brings its size in its own traffic file."""
import copy

import pytest
import torch

from tcbench import HERE, ROOT, run, spec

TRAFFIC = {w["name"]: spec.load_json(HERE / "traffic" / f"{w['name']}.json")
           for w in spec.load_json(ROOT / "BENCHMARK.json")["workloads"]}
SMALL = {name: t["small"] for name, t in TRAFFIC.items() if "small" in t}
CELLS = sorted(SMALL)
# the entry module each cell's window drives (``tcbench/entries/<entry>.py``)
ENTRY = {name: TRAFFIC[name]["entry"] for name in CELLS}


def small(cell):
    return copy.deepcopy(SMALL[cell])


def bench():
    b = spec.load()
    run.use_program()
    return b


def execute(cell, seed=20241017, seconds=0.3):
    b = bench()
    torch.manual_seed(0)
    return run.execute(b, spec.resolve(b, cell), seed, seconds, False, "cpu",
                       small(cell))


@pytest.fixture
def card():
    """Skips a test on a machine without a CUDA card (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
