"""Float64 operands on the card's kernels, the host side (no card, no jax):
the float64 instantiations' entry points and padding, the tile's float64
accumulator, the roofline and footprint prices at 8-byte elements; and the
diagnosis behind ``chip_smoke.py`` phase 11b's float64 GGN gate: the 2 x 2
gloo mesh's float32 GGN objectives lie within float32 rounding of the
envelope of LOCAL runs under five summation orders, with no offset of one
sign (``PERF.md`` §6). The kernels themselves are held in float64 on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 2, 4c)."""
import os
import sys

import pytest
import torch

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch.analysis.spmd import footprint as spmd_footprint  # noqa
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import footprint as kfootprint  # noqa: E402
from repro_torch.kernels import mttkrp as kmttkrp  # noqa: E402
from repro_torch.kernels.tile import KernelTile  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.obs.profile import Machine  # noqa: E402


# ---------------------------------------------------------------------------
# entry points, dtype codes, padding
# ---------------------------------------------------------------------------

def test_float64_has_its_instantiation_and_float16_none():
    d = torch.zeros(2, dtype=torch.float64)
    assert _build.operand_dtype(values=d, x=None, f=d) == torch.float64
    assert _build.entry("tttp", torch.float64) == "repro_tttp_f64"
    assert _build.entry("mttkrp_bucketed", torch.float64) == \
        "repro_mttkrp_bucketed_f64"
    assert _build.DTYPE_CODES[torch.float64] == 2
    assert _build.dtype_name(torch.float64) == "float64"
    with pytest.raises(TypeError, match="float16"):
        _build.operand_dtype(values=d.half())
    # mixed inputs are promoted by kernels.ops before a launcher sees them
    with pytest.raises(TypeError, match="one element type"):
        _build.operand_dtype(values=d, f=d.float())
    assert torch.result_type(d, d.float()) == torch.float64


def test_the_build_log_names_float64_instantiations():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_118bucket_rows_kernelILi16ELb1ELi2EdEEvPKT2_"
           "PKiS5_PKhxii11FactorTableIS1_ES3_xiiiPS1_' for 'sm_90a'\n"
           "ptxas info    : Used 174 registers\n")
    use = _build.resource_usage(log)
    assert use == {("bucket_rows_kernel", (16, 1, 2, "float64")): {
        "registers": 174, "smem": 0, "stack": 0, "spill_stores": 0,
        "spill_loads": 0}}


@pytest.mark.parametrize("r,width", [(1, 2), (3, 4), (10, 10), (33, 34)])
def test_pad_rows_float64_is_16_byte_rows(r, width):
    t = torch.randn(7, r, dtype=torch.float64)
    p = kmttkrp.pad_rows(t)
    assert p.dtype == torch.float64 and p.shape == (7, width)
    assert p.data_ptr() % 16 == 0 and (p.shape[1] * 8) % 16 == 0
    assert torch.equal(p[:, :r], t) and not p[:, r:].any()
    assert kmttkrp.padded_width(r, torch.float64) == width
    # R = 10: 80-byte rows, no padding; the row itself when it already is
    assert (kmttkrp.pad_rows(t) is t) == (r == width
                                          and t.data_ptr() % 16 == 0)


def test_launch_counters_split_float64():
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    # by element type, and by accumulator where a tile widens it
    assert all(set(c) == {"float32", "bfloat16", "float64",
                          "float32/float64", "bfloat16/float64"}
               for c in kops.launch_counts_by_dtype().values())
    assert _build.variant_name(torch.float32, torch.float64) == \
        "float32/float64"
    assert _build.variant_name(torch.float64, torch.float64) == "float64"
    assert _build.entry("mttkrp_bucketed", torch.bfloat16, torch.float64) \
        == "repro_mttkrp_bucketed_bf16_acc64"


# ---------------------------------------------------------------------------
# the tile's accumulator
# ---------------------------------------------------------------------------

def test_kernel_tile_takes_a_float64_accumulator():
    t = KernelTile(accum_dtype="float64")
    assert t.short() == "br8.t256.p2.f64"
    assert KernelTile.from_json(t.to_json()).accum_dtype == "float64"
    # the accumulator picks the instantiation: a key of its own
    assert t != KernelTile() and hash(t) != hash(KernelTile())
    assert t.accumulator(torch.float64) == torch.float64
    # float64 sums in float64 whatever the tile names
    assert KernelTile().accumulator(torch.float64) == torch.float64
    assert not t.widens(torch.float64)
    for dt in (torch.float32, torch.bfloat16):
        assert KernelTile().accumulator(dt) == torch.float32
        assert t.accumulator(dt) == torch.float64 and t.widens(dt)
    with pytest.raises(ValueError, match="float32 only"):
        KernelTile(accum_dtype="float16")


def test_a_float64_tile_on_float32_operands_refuses_before_the_card():
    """A float64 tile over float32 operands is accepted (no refusal is
    left): on the CPU the wrapper reaches the plain version's float64 sums,
    which keep the float32 output of terms that cancel, where a float32
    sum loses it."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    big = 2.0 ** 24
    vals = torch.ones(3)
    idx = torch.zeros(3, 1, dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    # one row of 3 columns: big + 1 - big in a sum over R
    f = torch.tensor([[big, 1.0, -big]])
    wide = kops._tttp(vals, idx, valid, [f], KernelTile(accum_dtype="float64"))
    narrow = kops._tttp(vals, idx, valid, [f], KernelTile())
    assert wide.dtype == narrow.dtype == torch.float32
    assert wide.tolist() == [1.0] * 3 and narrow.tolist() == [0.0] * 3
    assert torch.equal(kref.tttp_ref(vals, idx, valid, [f], torch.float64),
                       torch.ones(3, dtype=torch.float64))


# ---------------------------------------------------------------------------
# roofline and footprint at 8-byte elements
# ---------------------------------------------------------------------------

def test_kernel_terms_price_8_byte_elements_and_the_fp64_peak():
    kw = dict(slots=1000, nd=3, rank=10, valid=900, factor_rows=(50, 40),
              out_rows=64, x_rows=60)
    t32 = roofline.kernel_terms("cg_matvec", **kw)
    t64 = roofline.kernel_terms("cg_matvec", **kw, elem_bytes=8)
    assert t64["bytes"] - t32["bytes"] == (1000 * 4
                                           + 4 * 10 * (90 + 64 + 60))
    assert t64["flops"] == t32["flops"]
    # an 80-byte row spans 3 sectors at every 16-byte offset
    assert roofline.gather_sector_bytes(8, 10, 8) == 8 * 96
    m = Machine.from_env()
    assert m.peak_flops_f64 == roofline.PEAK_FLOPS_F64 == 34e12
    ops = 1e9
    assert roofline.bound(0, ops, m, elem_bytes=8) == (
        ops / 34e12 * 1e3, "operations")
    assert roofline.bound(0, ops, m) == (ops / 67e12 * 1e3, "operations")


def test_footprint_prices_float64_rows_and_instantiations():
    tile = KernelTile()
    g32, g64 = (kfootprint.KernelGeometry(
        nd=3, rank=10, factor_rows=(20, 30), capacity=64, x_rows=40,
        dtype=dt) for dt in (torch.float32, torch.float64))
    e32 = kfootprint.estimate_footprint("cg_matvec", tile, g32)
    e64 = kfootprint.estimate_footprint("cg_matvec", tile, g64)
    # R = 10: 12 floats a row in float32, 10 doubles in float64; one slab
    # of 8 rows per warp (8 warps of 256 threads) in the accumulator type,
    # and 8 rows of x in the compute type
    assert (e32.smem_bytes, e64.smem_bytes) == (4 * 8 * 8 * 12 + 4 * 8 * 12,
                                                8 * 8 * 8 * 10 + 8 * 8 * 10)
    assert e64.kernel == "bucket_rows_kernel<16, 1, 2, float64>"
    assert kfootprint.dynamic_smem_bytes(8, 10, True, torch.float64) == \
        e64.smem_bytes
    t = kfootprint.estimate_footprint("tttp", tile, g64)
    assert t.kernel == "tttp_kernel<2, 2, float64>" and t.smem_bytes == 0
    assert torch.float64 in spmd_footprint.DTYPES


# ---------------------------------------------------------------------------
# the diagnosis of phase 11b's float32 GGN envelope
# ---------------------------------------------------------------------------

def test_float32_mesh_ggn_objective_is_rounding_from_local():
    """Phase 11b's float32 check, on the CPU: the 2 x 2 gloo mesh's GGN
    objective before and after one iteration against the envelope
    of LOCAL runs under phase 11b's five summation orders. The mesh lies
    within 1e-6 (a few float32 units in the last place) of the envelope:
    the distance phase 11b's card runs showed (up to 1.8e-3) is the
    atomics' order carried through the solves, not a fault in the mesh's
    objective (over 8 seeds its offset took both signs; PERF.md, PR
    21)."""
    from repro_torch.launch import complete
    argv = ["--algorithm", "ggn", "--loss", "poisson_log", "--dims",
            "30,20,10", "--nnz", "600", "--rank", "4", "--cg-iters", "4",
            "--sweeps", "1", "--seed", "3", "--device", "cpu"]
    local = [complete.main(argv + list(o)).objective
             for o in complete.GGN_SUMMATION_ORDERS]
    mesh = complete.main(argv + ["--mesh", "2,2", "--force-host-devices",
                                 "4"]).runs[0].objective
    assert len(mesh) == 2
    for i, a in enumerate(mesh):
        vals = [run[i] for run in local]
        lo, hi = min(vals), max(vals)
        assert lo - 1e-6 * abs(lo) <= a <= hi + 1e-6 * abs(hi), (
            i, a, lo, hi)
