"""The trace arithmetic and the per-layer readers on a made-up trace."""
import types

import pytest

from tcbench import roofline, spec
from tcbench.trace import Trace, Tracer

MS = 1_000_000


def _trace():
    device = [
        ("void bucket_rows_kernel<16, true, 2, float, float>(...)",
         10 * MS, 40 * MS),
        ("void bucket_rows_kernel<16, true, 2, float, float>(...)",
         40 * MS, 70 * MS),
        ("void tttp_kernel<3, 2, float, float>(...)", 75 * MS, 85 * MS),
        ("void at::native::elementwise_kernel<...>", 80 * MS, 90 * MS),
        ("Memcpy DtoH (Device -> Pinned)", 95 * MS, 96 * MS),
    ]
    host = [("tcbench.sweep", 0, 72 * MS),
            ("aten::mul", 1 * MS, 9 * MS),
            ("tcbench.rmse", 72 * MS, 100 * MS),
            ("aten::item", 90 * MS, 100 * MS)]
    return Trace(device, host, (0, 100 * MS))


def test_busy_gaps_launches_and_names():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    # union: [10, 70] + [75, 90] + [95, 96]
    assert t.busy_s() == pytest.approx(0.076)
    assert t.gaps() == [(0, 10 * MS), (70 * MS, 75 * MS), (90 * MS, 95 * MS),
                        (96 * MS, 100 * MS)]
    assert t.launches() == 4
    labels = t.gap_labels()
    assert labels["tcbench.sweep > aten::mul"] == pytest.approx(0.010)
    assert labels["tcbench.rmse > aten::item"] == pytest.approx(0.009)
    assert sum(labels.values()) == pytest.approx(0.1 - 0.076)
    b = t.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(0.060)
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) <= 10


def _view(trace, **work):
    return types.SimpleNamespace(trace=trace, work=work, config={},
                                 traffic={})


def test_sweep_readers():
    t = _trace()
    passes = [["tttp", None, 1]] + [[k, d, c] for d in range(3) for k, c in
                                    (("mttkrp", 1), ("cg_matvec", 21))]
    w = dict(sweeps=2, passes=passes, nnz=1000, rank=4, rows=[10, 10, 10])
    read = {m: spec.load_reader(m).read for m in (
        "sweep_mfu", "aten_ms.sweep", "cg_matvec_roofline.sweep",
        "tttp_roofline.sweep", "idle_share.sweep")}
    bound = roofline.sweep_bound_s(passes, 1000, 4, [10] * 3)
    assert read["sweep_mfu"](_view(t, **w)) == \
        pytest.approx(100 * bound * 2 / 0.1)
    assert read["aten_ms.sweep"](_view(t, **w)) == pytest.approx(5.5)
    mv = roofline.pass_bound_s("cg_matvec", 1000, 3, 4, 20, 10)
    assert read["cg_matvec_roofline.sweep"](_view(t, **w)) == \
        pytest.approx(100 * mv / 0.030)
    tt = roofline.pass_bound_s("tttp", 1000, 3, 4, 30, 0)
    assert read["tttp_roofline.sweep"](_view(t, **w)) == \
        pytest.approx(100 * tt / 0.010)
    assert read["idle_share.sweep"](_view(t, **w)) == pytest.approx(24.0)
    w["sweeps"] = 0
    assert read["sweep_mfu"](_view(t, **w)) is None


def test_serve_readers_and_silence():
    t = _trace()
    launches = spec.load_reader("launches_per_batch.serve").read
    assert launches(_view(t, calls=2)) == 2.0
    fold = spec.load_reader("cg_matvec_roofline.foldin").read
    shapes = [(1000, 20, 8), (2000, 30, 8)]
    mean = sum(roofline.pass_bound_s("cg_matvec", m, 3, 4, r, u)
               for m, r, u in shapes) / 2
    assert fold(_view(t, calls=2, rank=4, nd=3, call_shapes=shapes)) == \
        pytest.approx(100 * mean / 0.030)
    # a reader that finds nothing to read returns nothing
    empty = Trace([], [], (0, MS))
    assert fold(_view(empty, calls=2, rank=4, nd=3, call_shapes=shapes)) \
        is None
    assert spec.load_reader("tttp_roofline.sweep").read(
        _view(empty, nnz=1, rank=1, rows=[1, 1, 1])) is None


def test_tracer_off_is_a_no_op():
    tr = Tracer(False)
    with tr.span("tcbench.sweep"):
        pass
    tr.start()
    assert tr.stop() is None
