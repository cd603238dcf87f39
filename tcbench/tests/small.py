"""Sizes at which the cells run on the CPU in the tests: the cells' own
traffic and settings, on smaller extents."""
import copy

import pytest
import torch

from tcbench import run, spec

SMALL = {
    "function-312m.als": {"config": {"shape": [1000, 1000, 1000],
                                     "nnz": 300000}},
    "function-78m.ggn-poisson": {"config": {"shape": [1000, 1000, 1000],
                                            "nnz": 300000}},
    "netflix-r32.foldin": {"config": {"shape": [3000, 1777, 218]},
                           "traffic": {"users_per_call": 64,
                                       "pool_calls": 4, "check_share": 0.5}},
    "netflix-r32.topk": {"config": {"shape": [3000, 1777, 218]},
                         "traffic": {"queries_per_call": 64,
                                     "pool_calls": 4, "check_share": 0.5}},
}
CELLS = sorted(SMALL)


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
