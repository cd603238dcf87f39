"""The generators: the same seed gives the same inputs, another seed other
inputs over the same sizes."""
import numpy as np
import pytest
import torch

from tcbench import gen

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, -3])
def test_derive_is_a_torch_seed_and_separates_purposes(seed):
    seeds = [gen.derive(seed, p) for p in gen.STREAMS]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 63 for s in seeds)
    torch.Generator().manual_seed(seeds[0])
    assert seeds == [gen.derive(seed, p) for p in gen.STREAMS]


def _tensor(seed, index_seed=11):
    return gen.function_tensor((30, 20, 10), 500,
                               gen.device_generator(index_seed, "tensor",
                                                    "cpu"),
                               gen.device_generator(seed, "tensor", "cpu"))


def test_function_tensor_is_deterministic_per_seed():
    (i1, v1), (i2, v2), (i3, v3) = _tensor(BIG), _tensor(BIG), _tensor(5)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    assert not torch.equal(v1, v3)
    assert i1.dtype == torch.int32 and i1.shape == (500, 3)
    assert (i1.max(0).values < torch.tensor([30, 20, 10])).all()
    assert ((v1 > 0) & (v1 < 1)).all()


def test_function_tensor_row_counts_are_the_same_for_every_seed():
    # the indices come from the configuration's index seed alone, i.i.d.
    # uniform (so rows differ in count, as in the program's generator)
    idx = [_tensor(seed)[0] for seed in (1, 2, BIG)]
    assert all(torch.equal(idx[0], i) for i in idx[1:])
    assert not torch.equal(idx[0], _tensor(1, index_seed=12)[0])
    counts = torch.bincount(idx[0][:, 0].long(), minlength=30)
    assert counts.max() > counts.min()


def test_normal_factors_are_deterministic_per_seed():
    a = gen.normal_factors((30, 20), 4, gen.device_generator(1, "factors",
                                                            "cpu"))
    b = gen.normal_factors((30, 20), 4, gen.device_generator(1, "factors",
                                                            "cpu"))
    c = gen.normal_factors((30, 20), 4, gen.device_generator(2, "factors",
                                                            "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


USERS = {"median": 96, "mean": 209.25, "min": 1, "max": 17770}
MOVIES = {"median": 561, "mean": 5654.5, "min": 3, "max": 232944}


def test_lognormal_counts_are_one_set_for_every_seed():
    counts = np.rint(gen.lognormal_quantiles(1024, USERS))
    assert counts.shape == (1024,) and counts.min() >= 1
    assert counts.max() <= 17770 and np.all(np.diff(counts) >= 0)
    assert np.median(counts) == 96 and abs(counts.mean() - 209.25) < 0.5
    movies = gen.lognormal_quantiles(17770, MOVIES)
    assert movies.min() == 3 and movies.max() == 232944
    assert movies.mean() == pytest.approx(5654.5)
    # the most-rated movie's share, as in the Netflix Prize data
    assert 0.002 < movies.max() / movies.sum() < 0.0025


def test_bucket_capacity_is_the_fullest_bucket_to_a_power_of_two():
    assert gen.bucket_capacity(np.array([3, 4, 1, 0, 0, 9]), 2) == 16
    assert gen.bucket_capacity(np.array([1, 0, 0]), 8) == 8
    assert gen.bucket_capacity(np.array([5000] * 8 + [1]), 8) == 65536


def _pool(seed):
    counts = np.rint(gen.lognormal_quantiles(
        32, dict(USERS, median=8, mean=15, max=50))).astype(np.int64)
    weights = gen.popularity(50, dict(MOVIES, median=5, mean=9, max=60), 3)
    return gen.foldin_pool(gen.device_generator(seed, "pool", "cpu"),
                           (100, 50, 20), 0, 3, counts, 1, weights, (1, 5),
                           7, chunk_users=64), counts


def test_foldin_pool_same_sizes_other_order_and_content():
    (a, counts), (b, _), (c, _) = _pool(BIG), _pool(BIG), _pool(9)
    for x, y in zip(a, b):
        assert np.array_equal(x.indices, y.indices)
        assert np.array_equal(x.values, y.values)
    for call in a + c:
        assert sorted(np.diff(call.offsets)) == sorted(counts)
        assert call.indices[:, 0].max() < 50 and call.indices[:, 1].max() < 20
        assert set(np.unique(call.values)) <= {1, 2, 3, 4, 5}
        assert len(call.histories) == 32
        # a movie at most once in a history
        assert all(len(np.unique(i[:, 0])) == len(i)
                   for i, _ in call.histories)
        assert call.distinct == len(np.unique(call.indices[:, 0])) + \
            len(np.unique(call.indices[:, 1]))
    # the same calls' sizes, in the same sequence, for every seed
    assert [tuple(np.diff(x.offsets)) for x in a] == \
        [tuple(np.diff(x.offsets)) for x in c]
    assert not all(np.array_equal(x.indices, y.indices)
                   for x, y in zip(a, c))


def test_topk_pool_is_deterministic_per_seed():
    w = gen.popularity(100, USERS, 5)

    def pool(seed):
        return gen.topk_pool(gen.device_generator(seed, "pool", "cpu"),
                             (100, 50, 20), 1, 5, 16, 0, w, chunk_calls=2)
    p1, p2, p3 = pool(BIG), pool(BIG), pool(3)
    assert len(p1) == 5 and sorted(p1[0]) == [0, 2]
    assert all(np.array_equal(p1[i][d], p2[i][d]) for i in range(5)
               for d in (0, 2))
    assert not np.array_equal(p1[0][0], p3[0][0])
    assert p1.fixed[0].max() < 100 and p1.fixed[2].max() < 20
    # no two calls alike
    assert len({p1[i][0].tobytes() for i in range(5)}) == 5


def _solver_inputs(cell, seed, index_seed=None):
    from tcbench import run, spec
    from tcbench.tests.small import small
    c = spec.resolve(spec.load(), cell)
    c.config.update(small(cell)["config"])
    if index_seed is not None:
        c.config["index_seed"] = index_seed
    return c.entry.Entry(run.context(c, seed, "cpu",
                                     run.Tracer(False))).inputs()


def test_solver_cells_draw_one_problem_for_every_seed():
    """A solver cell's tensor, values and start come from its
    configuration's ``index_seed`` alone: every ``--seed`` gives the same
    problem (so the same work), another ``index_seed`` another."""
    from tcbench.tests.small import CELLS, ENTRY
    cells = [c for c in CELLS if ENTRY[c] == "completion"]
    assert cells
    for cell in cells:
        a, b = _solver_inputs(cell, 1), _solver_inputs(cell, BIG)
        c = _solver_inputs(cell, 1, index_seed=5)
        for x, y, z in zip(a[:2] + tuple(a[2]), b[:2] + tuple(b[2]),
                           c[:2] + tuple(c[2])):
            assert torch.equal(x, y)
            assert x.shape == z.shape and not torch.equal(x, z)
