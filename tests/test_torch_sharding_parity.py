"""The port's sharding interpreter against the JAX package's
(``repro.analysis.spmd.sharding``) on the same planner grid: every order-3
case of both contract sweeps (7 families, local and each ``DistInfo``
variant) and each of its candidate paths reports the same set of rules in
both packages, with no fault planted, under a missing psum (SP001) and
under a double psum (SP002).

jax 0.9 no longer exports ``jax.core.Literal``, which the reference's
jaxpr walk reads; the fixture below lends it ``jax.extend.core.Literal``
for the length of a test (the JAX package itself is not changed)."""
import collections
import os
import re
import sys

import jax
import jax.extend.core
import pytest

from repro.analysis import contracts as jcontracts
from repro.analysis.spmd import sharding as jsharding
from repro.planner import cost as jcost

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.spmd import sharding  # noqa: E402
from repro_torch.planner import cost as pcost  # noqa: E402


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(jax.core, "Literal", jax.extend.core.Literal,
                        raising=False)
    return jsharding


def rules_by_label(findings):
    """{"case/path": {rules}} from findings that open with their label."""
    out = collections.defaultdict(set)
    for f in findings:
        out[re.match(r"\[([^\]]*)\]", f.message).group(1)].add(f.rule)
    return dict(out)


def test_both_sweeps_walk_the_same_grid():
    want = {(c.name, p) for c in jcontracts.iter_cases((3,))
            for p in jcost.candidate_paths(c.ir)}
    got = {(c.name, p) for c in contracts.iter_cases((3,), device="cpu")
           for p in pcost.candidate_paths(c.ir)}
    assert got == want and len(got) > 50


@pytest.mark.parametrize("fault", [None, "missing-psum", "double-psum"])
def test_same_rules_per_case_and_path(reference, fault):
    reference.set_fault(fault)
    sharding.set_fault(fault)
    try:
        want = rules_by_label(reference.check_cases(orders=(3,)))
        got = rules_by_label(sharding.check_cases(orders=(3,),
                                                  device="cpu"))
    finally:
        reference.set_fault(None)
        sharding.set_fault(None)
    assert got == want
    expect = {None: set(), "missing-psum": {"SP001"},
              "double-psum": {"SP002"}}[fault]
    assert set().union(*want.values()) == expect
