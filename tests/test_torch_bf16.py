"""bf16 inputs: the port's kernels against the reference's Pallas kernels
in interpret mode (``use_pallas=True``), on the same numpy inputs rounded to
bf16, at the reference's documented bf16 bound (rtol = atol = 6e-2,
``tests/test_golden.py``), compared in float32; the reference's float64
goldens read by the port; the result dtype rule (``kernels/ops.py:
_out_dtype``) for bf16 and mixed inputs; and the host side of the bf16
launches (row strides, operand checks, the dtype-priced bound). On the CPU
the port runs its plain versions; ``tests/test_torch_cuda.py`` holds the
bf16 CUDA instantiations against them on the card."""
import glob
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.kernels import ops as jkops
from repro.sparse.ccsr import bucketize as jbucketize

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop
from repro_torch.kernels import _build
from repro_torch.kernels import mttkrp as kmttkrp
from repro_torch.kernels import ops as kops
from repro_torch.launch import roofline

BF16_TOL = dict(rtol=6e-2, atol=6e-2)
GOLDEN_FILES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden", "golden_*.npz")))


def _bf16_np(a):
    """``a`` rounded to bf16, as float32 numpy (exact in both packages)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _problem(seed, shape, nnz, r):
    """The same bf16-rounded padded COO and factors in both packages: (jax
    bf16 tensor, jax bf16 factors, torch bf16 tensor, torch bf16 factors)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape],
                   1).astype(np.int32)
    vals = _bf16_np(rng.standard_normal(nnz))
    j = JSparseTensor.from_coo(jnp.asarray(idx), jnp.asarray(vals), shape,
                               cap=nnz + 37)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values),
                                  np.asarray(j.valid), shape, "cpu")
    fnp = [_bf16_np(rng.standard_normal((s, r))) for s in shape]
    return (j.astype(jnp.bfloat16), [jnp.asarray(f, jnp.bfloat16)
                                     for f in fnp],
            t.astype(torch.bfloat16),
            [torch.from_numpy(f).to(torch.bfloat16) for f in fnp])


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("shape,nnz,r", [((64, 32, 16), 500, 16),
                                         ((20, 12, 10, 8), 300, 10)])
def test_tttp_bf16_matches_pallas(shape, nnz, r):
    j, jf, t, tf = _problem(0, shape, nnz, r)
    want = jkops.tttp_values(j, jf, use_pallas=True)
    got = kops.tttp_values(t, tf)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("mode", [0, 2])
def test_mttkrp_bf16_matches_pallas(mode):
    shape = (64, 32, 16)
    j, jf, t, tf = _problem(1, shape, 500, 16)
    jf[mode], tf[mode] = None, None
    want = jkops.mttkrp_bucketed(jbucketize(j, mode, block_rows=8), jf,
                                 num_rows=shape[mode], use_pallas=True)
    got = kops.mttkrp_bucketed(t.row_buckets(mode, 8), tf)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def test_cg_matvec_bf16_matches_pallas():
    shape = (64, 32, 16)
    j, jf, t, tf = _problem(2, shape, 500, 16)
    jo = j.with_values(jnp.ones_like(j.values))
    to = t.with_values(torch.ones_like(t.values))
    xnp = _bf16_np(np.random.default_rng(3).standard_normal((64, 16)))
    jx, tx = jnp.asarray(xnp, jnp.bfloat16), torch.from_numpy(xnp).bfloat16()
    want = jkops.cg_matvec_bucketed(jbucketize(jo, 0, block_rows=8),
                                    [None] + jf[1:], jx, num_rows=64,
                                    use_pallas=True)
    got = kops.cg_matvec_bucketed(to.row_buckets(0, 8), [None] + tf[1:], tx)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("path", GOLDEN_FILES,
                         ids=[os.path.basename(p)[:-4] for p in GOLDEN_FILES])
def test_golden_bf16_within_documented_bound(path):
    """The reference's float64 goldens, read by the port: bf16 inputs stay
    within the bound and come back in bf16."""
    z = np.load(path)
    shape = tuple(int(s) for s in z["shape"])
    st = interop.sparse_from_numpy(z["indices"], z["values"], z["valid"],
                                   shape, "cpu").astype(torch.bfloat16)
    fs = [torch.from_numpy(z[f"factor_{d}"]).to(torch.bfloat16)
          for d in range(len(shape))]
    got = kops.tttp_values(st, fs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), z["tttp_vals"], **BF16_TOL)
    bk = st.row_buckets(0, 8)
    got = kops.mttkrp_bucketed(bk, [None] + fs[1:])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), z["mttkrp_m0"], **BF16_TOL)
    x = torch.from_numpy(z["x"]).to(torch.bfloat16)
    got = kops.cg_matvec_bucketed(bk, [None] + fs[1:], x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), z["cg_m0"], **BF16_TOL)


def test_mixed_inputs_follow_the_references_dtype_rule():
    """The result dtype of mixed bf16/f32 inputs is the reference's
    (``_out_dtype``: the values, or x for the Gram matvec, promoted with
    the factors; the matvec's weights stay out of it)."""
    shape = (40, 24, 12)
    j, jf, t, tf = _problem(4, shape, 300, 8)
    jf32, tf32 = ([f.astype(jnp.float32) for f in jf],
                  [f.float() for f in tf])
    want = jkops.tttp_values(j, jf32, use_pallas=True)
    got = kops.tttp_values(t, tf32)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    jo = j.with_values(jnp.ones_like(j.values)).astype(jnp.float32)
    to = t.with_values(torch.ones_like(t.values)).astype(torch.float32)
    jx, tx = jf[0], tf[0]
    want = jkops.cg_matvec_bucketed(jbucketize(jo, 0, block_rows=8),
                                    [None] + jf[1:], jx, num_rows=40,
                                    use_pallas=True)
    got = kops.cg_matvec_bucketed(to.row_buckets(0, 8), [None] + tf[1:], tx)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# the host side of a bf16 launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,width", [(1, 8), (10, 16), (16, 16), (33, 40)])
def test_pad_rows_bf16_is_16_byte_rows(r, width):
    t = torch.randn(7, r).bfloat16()
    p = kmttkrp.pad_rows(t)
    assert p.dtype == torch.bfloat16 and p.shape == (7, width)
    assert p.data_ptr() % 16 == 0 and (p.shape[1] * 2) % 16 == 0
    assert torch.equal(p[:, :r], t) and not p[:, r:].any()
    assert kmttkrp.padded_width(r, torch.bfloat16) == width
    assert kmttkrp.padded_width(r, torch.float32) == -(-r // 4) * 4


def test_operand_dtype_takes_one_kernel_type():
    f32, b16 = torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)
    assert _build.operand_dtype(values=b16, x=None, f=b16) == torch.bfloat16
    assert _build.operand_dtype(values=f32) == torch.float32
    with pytest.raises(TypeError, match="one element type"):
        _build.operand_dtype(values=f32, f=b16)
    # float64 has its own instantiation; float16 none
    assert _build.operand_dtype(values=f32.double(),
                                f=f32.double()) == torch.float64
    with pytest.raises(TypeError, match="float16"):
        _build.operand_dtype(values=f32.half())
    assert _build.entry("tttp", torch.bfloat16) == "repro_tttp_bf16"
    assert _build.entry("cg_matvec_bucketed", torch.float32) == \
        "repro_cg_matvec_bucketed_f32"
    assert set(_build.SIGNATURES) >= {
        f"repro_{k}_{s}" for k in ("tttp", "mttkrp_bucketed",
                                   "cg_matvec_bucketed")
        for s in ("f32", "bf16", "f64")}


def test_bound_and_gathers_are_priced_by_dtype():
    """At R = 10 a bf16 row is 32 bytes, one sector; a float32 row 48
    bytes, two sectors at every offset. The bf16 bound moves 2-byte values,
    factors and outputs."""
    assert roofline.gather_sector_bytes(8, 10, 2) == 8 * 32
    assert roofline.gather_sector_bytes(8, 10) == 8 * 64
    kw = dict(slots=1000, nd=3, rank=10, valid=900, factor_rows=(50, 40),
              out_rows=64, x_rows=60)
    t32 = roofline.kernel_terms("cg_matvec", **kw)
    t16 = roofline.kernel_terms("cg_matvec", **kw, elem_bytes=2)
    assert t32["bytes"] - t16["bytes"] == (1000 * 2 + 2 * 10 * (90 + 64 + 60))
    assert t32["flops"] == t16["flops"]
