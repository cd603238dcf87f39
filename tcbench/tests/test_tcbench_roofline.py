"""Bytes and operations of the cells' passes against hand counts."""
import pytest

from tcbench import HERE, spec
from tcbench import roofline as R

M, N, RANK, ROWS = 78_125_000, 3, 10, 16_384


def test_entry_bytes_of_the_function_cell():
    # a float32 value and three int32 indices an entry
    assert R.entry_bytes(M, N) == 78_125_000 * 16 == 1_250_000_000


def test_pass_bytes_by_hand():
    factors = 2 * ROWS * RANK * 4
    assert R.pass_bytes("cg_matvec", M, N, RANK, 2 * ROWS, ROWS) == \
        1_250_000_000 + factors + 2 * ROWS * RANK * 4
    assert R.pass_bytes("mttkrp", M, N, RANK, 2 * ROWS, ROWS) == \
        1_250_000_000 + factors + ROWS * RANK * 4
    assert R.pass_bytes("tttp", M, N, RANK, 3 * ROWS, 0) == \
        1_250_000_000 + 3 * ROWS * RANK * 4 + M * 4
    with pytest.raises(ValueError):
        R.pass_bytes("spmv", M, N, RANK, 1, 1)


def test_passes_are_bandwidth_bound_at_the_cells_shapes():
    b = R.pass_bound_s("cg_matvec", M, N, RANK, 2 * ROWS, ROWS)
    assert b == pytest.approx((1_250_000_000 + 4 * ROWS * RANK * 4) / 3.35e12)
    assert R.pass_flops("cg_matvec", M, N, RANK) / R.FP32_FLOPS_PER_S < b


def _counts(cell):
    out = {}
    for kind, _, count in spec.load_json(
            HERE / "traffic" / f"{cell}.json")["passes"]:
        out[kind] = out.get(kind, 0) + count
    return out


def test_sweep_passes_match_the_solvers_launch_counts():
    # an ALS sweep: 3 MTTKRPs and 3 x (1 + 20) matvecs, and the RMSE's TTTP
    assert _counts("function-312m.als") == \
        {"tttp": 1, "mttkrp": 3, "cg_matvec": 63}
    # a GGN iteration launches 63 / 54 / 447; the harness's RMSE and
    # objective add two TTTPs
    assert _counts("function-78m.ggn-poisson") == \
        {"tttp": 65, "mttkrp": 54, "cg_matvec": 447}


def test_als_sweep_bound_by_hand():
    rows = [ROWS] * 3
    matvec = R.pass_bound_s("cg_matvec", M, N, RANK, 2 * ROWS, ROWS)
    mttkrp = R.pass_bound_s("mttkrp", M, N, RANK, 2 * ROWS, ROWS)
    tttp = R.pass_bound_s("tttp", M, N, RANK, 3 * ROWS, 0)
    passes = spec.load_json(HERE / "traffic" / "function-312m.als.json")[
        "passes"]
    assert R.sweep_bound_s(passes, M, RANK, rows) == \
        pytest.approx(63 * matvec + 3 * mttkrp + tttp)
    assert 0.0249 < R.sweep_bound_s(passes, M, RANK, rows) < 0.0256
