"""Parity of the PyTorch port's streamed ingest with the JAX package's.

The stream generators seed numpy alone and the shard hash is splitmix64, so
the same stream must give the same train and test tensors, ingest stats and
bucket patterns in both packages, bit for bit: nothing is handed across
except the stream's parameters. The port runs on the CPU here, where its
TTTP wrapper takes its plain version; ``heldout_metrics`` sums in float32
in both packages, in different orders, and is held at rtol 1e-6."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_tensor import SparseTensor as JSparseTensor
from repro.data import pipeline as jpipeline
from repro.data import streaming as jstreaming
from repro.sparse import ccsr as jccsr

# the port lives in port/ (beside src/, which holds only the JAX package)
PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "port")
sys.path.insert(0, PORT)

from repro_torch import interop  # noqa: E402
from repro_torch.data import pipeline, streaming, synthetic  # noqa: E402
from repro_torch.sparse import ccsr  # noqa: E402

SHAPE = (40, 30, 12)
NF_SHAPE = (50, 40, 10)


def _write_triplets(path, seed=3, nnz=900):
    """A one-based triplet file of function-stream entries, with a comment
    line."""
    with open(path, "w") as f:
        f.write("# i j k value\n")
        for c in jstreaming.function_stream(seed, SHAPE, nnz, 400):
            for (i, j, k), v in zip(c.indices, c.values):
                f.write(f"{i + 1} {j + 1} {k + 1} {float(v)!r}\n")


def _streams(kind, tmp_path):
    """The same stream from both packages: (reference, port, shape)."""
    if kind == "function":
        return (jstreaming.function_stream(7, SHAPE, 5000, 1200),
                streaming.function_stream(7, SHAPE, 5000, 1200), SHAPE)
    if kind == "netflix":
        return (jstreaming.netflix_stream(5, NF_SHAPE, 5000, 1300),
                streaming.netflix_stream(5, NF_SHAPE, 5000, 1300), NF_SHAPE)
    path = str(tmp_path / "triplets.txt")
    _write_triplets(path)
    return (jstreaming.triplet_file_stream(path, 3, 256, one_based=True),
            streaming.triplet_file_stream(path, 3, 256, one_based=True),
            SHAPE)


def _same_tensor(port, ref):
    assert port.shape == ref.shape
    assert port.nnz == ref.nnz
    assert port.nnz_rows == ref.nnz_rows
    assert port.sorted_mode == ref.sorted_mode
    for name in ("indices", "values", "valid"):
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("spool", [False, True], ids=["memory", "spool"])
@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("kind", ["function", "netflix", "file"])
def test_ingest_matches_reference(kind, num_shards, spool, tmp_path):
    jchunks, chunks, shape = _streams(kind, tmp_path)
    jdir = str(tmp_path / "jspool") if spool else None
    pdir = str(tmp_path / "pspool") if spool else None
    jtr, jte, jst = jstreaming.ingest(jchunks, shape, num_shards=num_shards,
                                      spool_dir=jdir, test_fraction=0.1,
                                      block_rows=8)
    tr, te, st = streaming.ingest(chunks, shape, num_shards=num_shards,
                                  spool_dir=pdir, test_fraction=0.1,
                                  block_rows=8, device="cpu")
    assert tr.device.type == "cpu"
    _same_tensor(tr, jtr)
    _same_tensor(te, jte)
    for field in ("shape", "num_shards", "entries_read", "entries_kept",
                  "nnz", "shard_nnz", "nnz_rows", "chunks",
                  "duplicates_dropped", "bucket_block_rows", "spills"):
        assert getattr(st, field) == getattr(jst, field), field
    assert len(st.bucket_counts) == len(jst.bucket_counts) == 3
    for got, want in zip(st.bucket_counts, jst.bucket_counts):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    te_st = st.test_stats
    assert te_st.nnz == jte.nnz
    assert st.entries_read + te_st.entries_read == sum(
        len(c) for c in _streams(kind, tmp_path)[1])
    assert st.entries_read == st.nnz + st.duplicates_dropped
    assert te_st.entries_read == te_st.nnz + te_st.duplicates_dropped
    if spool:
        assert st.spills > 0
        assert len(os.listdir(pdir)) == len(os.listdir(jdir))


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.5])
def test_split_chunk_matches_reference(fraction):
    (jc,) = list(jstreaming.function_stream(11, SHAPE, 3000, 3000))
    (c,) = list(streaming.function_stream(11, SHAPE, 3000, 3000))
    jtr, jte = jstreaming.split_chunk(jc, SHAPE, fraction)
    tr, te = streaming.split_chunk(c, SHAPE, fraction)
    for got, want in ((tr, jtr), (te, jte)):
        assert np.array_equal(got.indices, want.indices)
        assert np.array_equal(got.values, want.values)
    assert len(tr) + len(te) == 3000


@pytest.mark.parametrize("num_shards", [1, 3])
def test_from_stream_patterns_match_reference(num_shards):
    """The dataset's tensors, stats and every mode's bucket pattern (built
    at the capacity the streamed counts give) equal the reference's
    ``bucket_pattern`` at that capacity; ``omega`` shares the patterns."""
    jds = jpipeline.CompletionDataset.from_stream(
        jstreaming.netflix_stream(2, NF_SHAPE, 6000, 1500), NF_SHAPE,
        num_shards=num_shards, test_fraction=0.1, block_rows=8)
    ds = pipeline.CompletionDataset.from_stream(
        streaming.netflix_stream(2, NF_SHAPE, 6000, 1500), NF_SHAPE,
        num_shards=num_shards, test_fraction=0.1, device="cpu")
    assert ds.block_rows == 8 and ds.num_shards == num_shards
    _same_tensor(ds.tensor, jds.tensor)
    _same_tensor(ds.test, jds.test)
    for got, want in zip(ds.gather_global(), jds.gather_global()):
        assert np.array_equal(got, want)
    for mode in range(3):
        cap = jccsr.bucket_capacity(jds.stats.bucket_counts[mode])
        want = jccsr.bucket_pattern(jds.tensor, mode, 8, capacity=cap)
        got = ds.tensor._pattern_cache[(mode, 8)]
        assert ds.omega._pattern_cache[(mode, 8)] is got
        for name in ("sel", "indices", "local_row", "valid"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and np.array_equal(g, w), (mode, name)


def test_from_stream_refuses_a_mesh():
    with pytest.raises(ValueError, match="one device"):
        pipeline.CompletionDataset.from_stream(
            streaming.function_stream(0, SHAPE, 100, 100), SHAPE,
            mesh=object(), device="cpu")


def test_streamed_counts_are_upper_bounds():
    """Duplicates across chunks, dropped at the merge, leave the streamed
    counts above (never below) each bucket's occupancy, so the capacity
    holds every bucket; the builder's pattern equals a direct build at
    that capacity."""
    chunks = list(streaming.netflix_stream(4, NF_SHAPE, 4000, 700))
    builder = ccsr.IncrementalBucketBuilder(NF_SHAPE, 8)
    jbuilder = jccsr.IncrementalBucketBuilder(NF_SHAPE, 8)
    ing = streaming.StreamingIngest(NF_SHAPE, 1)
    for c in chunks:
        builder.observe(c.indices)
        jbuilder.observe(c.indices)
        ing.add(c)
    shards, stats = ing.finalize()
    assert stats.duplicates_dropped > 0
    st = streaming.pack_shards(shards, NF_SHAPE, stats, device="cpu")
    idx = st.indices[st.valid].numpy()
    over = 0
    for mode in range(3):
        assert np.array_equal(builder.counts[mode], jbuilder.counts[mode])
        actual = np.bincount(idx[:, mode] // 8,
                             minlength=builder.counts[mode].shape[0])
        assert (builder.counts[mode] >= actual).all()
        over += int((builder.counts[mode] - actual).sum())
        assert builder.capacity(mode) >= actual.max()
        got = builder.build(st, mode)
        want = ccsr.bucket_pattern(st, mode, 8,
                                   capacity=builder.capacity(mode))
        for name in ("sel", "indices", "local_row", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name))
    assert over > 0


def _factors(seed, shape, r, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((d, r))).astype(np.float32)
            for d in shape]


def _both(jst):
    return interop.sparse_from_numpy(np.asarray(jst.indices),
                                     np.asarray(jst.values),
                                     np.asarray(jst.valid), jst.shape, "cpu")


@pytest.mark.parametrize("link", ["identity", "log"])
def test_heldout_metrics_match_reference(link):
    _, jte, _ = jstreaming.ingest(
        jstreaming.function_stream(9, SHAPE, 6000, 2000), SHAPE,
        test_fraction=0.2)
    te = _both(jte)
    for seed, scale in ((0, 0.5), (1, 3.0)):   # 3.0 reaches the ±30 clip
        fs = _factors(seed, SHAPE, 4, scale)
        want = jstreaming.heldout_metrics(jte, [jnp.asarray(f) for f in fs],
                                          link=link)
        got = streaming.heldout_metrics(te, interop.factors_from_numpy(
            fs, "cpu"), link=link)
        assert got["count"] == want["count"] == jte.nnz
        for key in ("rmse", "poisson_deviance"):
            assert np.isfinite(got[key])
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_heldout_metrics_all_masked_and_bad_link():
    jst = JSparseTensor.from_coo(np.zeros((0, 3), np.int32),
                                 np.zeros((0,), np.float32), SHAPE, cap=16)
    st = _both(jst)
    fs = [np.ones((d, 2), np.float32) for d in SHAPE]
    want = jstreaming.heldout_metrics(jst, [jnp.asarray(f) for f in fs])
    got = streaming.heldout_metrics(st, interop.factors_from_numpy(fs, "cpu"))
    assert got == want == {"rmse": 0.0, "poisson_deviance": 0.0, "count": 1}
    with pytest.raises(ValueError, match="unknown link"):
        streaming.heldout_metrics(st, interop.factors_from_numpy(fs, "cpu"),
                                  link="logit")


def test_netflix_like_exact_nnz_unique_ratings():
    gen = torch.Generator().manual_seed(0)
    st = synthetic.netflix_like((50, 40, 10), 2000, gen)
    assert st.nnz == 2000 and int(st.valid.sum()) == 2000
    idx = st.indices[st.valid].numpy()
    assert np.unique(streaming._linearize64(idx, (50, 40, 10))).size == 2000
    vals = st.values[st.valid]
    assert torch.equal(vals, torch.round(vals))
    assert float(vals.min()) >= 1.0 and float(vals.max()) <= 5.0
    # Zipf skew: the most popular user holds far more than the mean
    counts = np.bincount(idx[:, 0], minlength=50)
    assert counts.max() > 4 * counts.mean()
    with pytest.raises(ValueError, match="exceeds"):
        synthetic.netflix_like((4, 4, 4), 100, gen)


def test_builder_resumes_from_streamed_counts():
    """A builder made from the counts ``IngestStats`` carries gives the
    capacity ``from_stream`` builds its patterns at."""
    ds = pipeline.CompletionDataset.from_stream(
        streaming.netflix_stream(2, NF_SHAPE, 6000, 1500), NF_SHAPE,
        test_fraction=0.1, device="cpu")
    builder = ccsr.IncrementalBucketBuilder(NF_SHAPE, 8,
                                            ds.stats.bucket_counts)
    for mode in range(3):
        assert builder.capacity(mode) == jccsr.bucket_capacity(
            ds.stats.bucket_counts[mode])
        assert (ds.tensor._pattern_cache[(mode, 8)].sel.shape[1]
                == builder.capacity(mode))


def test_prefetch_yields_in_order_and_raises_at_the_failing_item():
    def items():
        yield from range(5)
        raise KeyError("chunk 5")

    got = []
    with pytest.raises(KeyError, match="chunk 5"):
        for x in pipeline.prefetch(items()):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert list(pipeline.prefetch([])) == []
    assert list(pipeline.prefetch(iter("abc"))) == ["a", "b", "c"]


def test_prefetch_makes_one_item_ahead():
    """The worker makes item k + 2 only once the caller has taken item
    k + 1: a long chunk stream is never held whole."""
    import threading
    import time
    made = []
    lock = threading.Lock()

    def items():
        for i in range(12):
            with lock:
                made.append(i)
            yield i

    it = pipeline.prefetch(items())
    for k in range(6):
        assert next(it) == k
        time.sleep(0.02)  # give the worker the time to run ahead
        with lock:
            assert len(made) <= k + 2, (k, len(made))
    assert list(it) == list(range(6, 12))
