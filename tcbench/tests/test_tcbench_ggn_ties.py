"""The GGN reference's two choices (the line search's step, accept or
reject) where the program's damping says that it chose otherwise: taken
from the program only where the reference cannot tell the two apart."""
import pytest

from tcbench.reference import ggn

GRID = (2.0, 1.5, 1.25, 1.0, 0.8, 0.65, 0.5, 0.4, 0.3, 0.2, 0.1)
TIE = 4e-5


@pytest.mark.parametrize("ok,kind,scale", [(True, 2, 0.5), (True, 1, 1.0),
                                           (True, 0, 3.0),
                                           (False, None, 10.0)])
def test_damping_says_what_the_program_chose(ok, kind, scale):
    mu = 1e-5
    assert ggn.said(mu, mu * scale * (1 + 3e-8)) == (ok, kind)


def test_damping_off_the_schedule_says_nothing():
    assert ggn.said(1e-5, 1e-5 * 2.0) is None
    assert ggn.said(1e-5, None) is None


def _objs(best, near, rest=2.0):
    """Objectives over GRID: 1.0 at ``best``, 1.0 + ``near`` at 1.0's
    neighbour 0.8 or 1.0, ``rest`` elsewhere."""
    return [1.0 if a == best else (1.0 + near if a in (0.8, 1.0) else rest)
            for a in GRID]


def test_step_of_the_same_class_is_the_references_own():
    objs = _objs(0.8, 1e-7)
    assert ggn.choose_step(GRID, objs, 3.0, (True, 1), TIE) == (0.8, None)
    assert ggn.choose_step(GRID, objs, 3.0, None, TIE) == (0.8, None)
    assert ggn.choose_step(GRID, objs, 3.0, (False, None), TIE) == (0.8,
                                                                    None)


def test_step_at_a_tie_is_the_programs():
    alpha, note = ggn.choose_step(GRID, _objs(0.8, 1e-5), 3.0, (True, 2),
                                  TIE)
    assert alpha == 1.0 and note["taken"] == 1.0 and note["step"] == 0.8
    assert note["gap"] == pytest.approx(1e-5 / 3.0)


def test_step_beyond_a_tie_stays_the_references():
    alpha, note = ggn.choose_step(GRID, _objs(0.8, 1e-3), 3.0, (True, 2),
                                  TIE)
    assert alpha == 0.8 and "taken" not in note
    assert note["gap"] == pytest.approx(1e-3 / 3.0)


def test_no_decrease_is_a_step_of_zero():
    objs = [3.0 + 1e-5] * len(GRID)
    assert ggn.choose_step(GRID, objs, 3.0, None, TIE) == (0.0, None)
    alpha, note = ggn.choose_step(GRID, objs, 3.0, (True, 2), TIE)
    assert alpha == 2.0 and note["taken"] == 2.0


@pytest.mark.parametrize("f_new,took,want", [
    (1.0 - 1e-6, (False, None), False),     # a tie: the program's
    (1.0 + 1e-6, (True, 2), True),
    (1.0 - 1e-3, (False, None), True),      # beyond it: the reference's
    (1.0 + 1e-3, (True, 2), False),
    (1.0 - 1e-3, (True, 0), True),          # the same choice: no note
])
def test_accept_follows_the_program_only_at_a_tie(f_new, took, want):
    ok, note = ggn.choose_accept(1.0, f_new, took, TIE)
    assert ok is want
    assert (note is None) == (took[0] == (f_new <= 1.0))
