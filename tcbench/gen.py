"""Input generators, frozen for the benchmark: the same seed gives the same
inputs whatever a later change does to the program's own generators.

Every stream of random numbers is derived from a seed and a purpose
(:func:`derive`), so the tensor's indices and values, the initial
factors, the program's ingest shuffle, the request pool and the sample of
checked answers are drawn independently and in the same way on every run
of a seed. What a deployment fixes is drawn from seeds in its files, the
same for every ``--seed``: the function tensor, its values and the
solver's start (a configuration's ``index_seed``), and which id takes
which popularity and how each pooled call orders its sizes (a traffic
file's ``layout_seed``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# the purposes a run draws for; their order is part of the yardstick
STREAMS = ("tensor", "factors", "ingest", "pool", "sample", "values")


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed made from ``seed`` (any whole number) and a purpose."""
    words = [int(seed) % (1 << 64), STREAMS.index(purpose)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def device_generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def host_rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose))


# copied from port/repro_torch/data/synthetic.py ``function_tensor``: the
# indices and the grids drawn from two generators
def function_tensor(shape: Sequence[int], nnz: int,
                    index_generator: torch.Generator,
                    value_generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's synthetic function tensor (Fig. 7a): t_i = sigmoid(3 ·
    Σ_d x_d[i_d]) with x_d ~ U[-1, 1] (from ``value_generator``) at i.i.d.
    uniform indices (from ``index_generator``). Returns ``(indices (nnz, N)
    int32, values (nnz,) float32)`` on the generators' device."""
    dev = index_generator.device
    idx_cols = [torch.randint(0, s, (nnz,), generator=index_generator,
                              device=dev, dtype=torch.int32) for s in shape]
    grids = [torch.rand(s, generator=value_generator, device=dev) * 2.0 - 1.0
             for s in shape]
    arg = sum(g[i] for g, i in zip(grids, idx_cols))
    vals = torch.sigmoid(3.0 * arg)
    return torch.stack(idx_cols, dim=1), vals


# copied from port/repro_torch/launch/complete.py ``load_problem``
def normal_factors(shape: Sequence[int], rank: int,
                   generator: torch.Generator) -> List[torch.Tensor]:
    """Factors drawn N(0, 1/R), one (I_d, R) float32 matrix a mode, on the
    generator's device."""
    return [torch.randn(d, rank, generator=generator,
                        device=generator.device) / rank ** 0.5
            for d in shape]




def lognormal_quantiles(n: int, law: Dict) -> np.ndarray:
    """``n`` values of a lognormal law fitted to published counts: its
    median is ``law["median"]``, and its shape σ makes the mean of its
    quantiles at (i + ½)/n, clipped to [``law["min"]``, ``law["max"]``],
    ``law["mean"]``. Ascending, float64; the same for every seed."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    z = torch.special.ndtri(q).numpy()
    lo, hi, mu = law["min"], law["max"], np.log(law["median"])

    def mean(sigma: float) -> float:
        return float(np.clip(np.exp(mu + sigma * z), lo, hi).mean())

    a, b = 0.0, 8.0
    for _ in range(60):
        mid = (a + b) / 2
        a, b = (mid, b) if mean(mid) < law["mean"] else (a, mid)
    return np.clip(np.exp(mu + (a + b) / 2 * z), lo, hi)


def popularity(n: int, law: Dict, layout_seed: int) -> np.ndarray:
    """The weight of each of ``n`` ids: the law's quantiles dealt to the
    ids in an order drawn from ``layout_seed`` (ids carry no rank, as a
    catalog's numbering does not), the same for every seed."""
    q = lognormal_quantiles(n, law)
    return q[np.random.default_rng(layout_seed).permutation(n)]


def bucket_capacity(lengths: np.ndarray, users: int) -> int:
    """The serving engine's graph key for a fold-in call (``serve/engine.py``
    ``history_buckets``): the fullest bucket of ``users`` consecutive users,
    in entries, padded to a power of two, at least ``users``."""
    pad = -len(lengths) % users
    full = int(np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
               .reshape(-1, users).sum(1).max())
    return max(users, 1 << max(full - 1, 0).bit_length())


class FoldinCall:
    """One fold-in request: ``users`` histories over the modes other than
    the folded one, as flat arrays (``indices`` (n, N-1) int32, ``values``
    (n,) float32, ``offsets`` (users + 1,)) and as the per-user views the
    serving engine takes; ``distinct`` counts the factor rows its histories
    touch, over those modes."""

    def __init__(self, indices: np.ndarray, values: np.ndarray,
                 offsets: np.ndarray, distinct: int):
        self.indices, self.values, self.offsets = indices, values, offsets
        self.distinct = distinct
        self.histories = [(indices[a:b], values[a:b])
                          for a, b in zip(offsets[:-1], offsets[1:])]

    @property
    def nnz(self) -> int:
        return int(self.offsets[-1])


def _without_replacement(generator: torch.Generator, weights: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """For each user ``lengths[u]`` distinct ids drawn by ``weights`` (the
    Gumbel top-k draw: each id once, as a user rates a title once), flat in
    user order (int32)."""
    keys = torch.log(weights)[None, :] - torch.log(-torch.log(
        torch.rand((len(lengths), len(weights)), generator=generator,
                   device=weights.device, dtype=torch.float32)
        .clamp_(min=1e-38)))
    ids = torch.topk(keys, int(lengths.max()), dim=1).indices
    keep = torch.arange(ids.shape[1], device=ids.device)[None, :] < \
        lengths[:, None]
    return ids[keep].to(torch.int32)


def foldin_pool(generator: torch.Generator, shape: Sequence[int], mode: int,
                calls: int, lengths: np.ndarray, popular: int,
                weights: np.ndarray, ratings: Tuple[int, int],
                layout_seed: int, chunk_users: int = 1024
                ) -> List[FoldinCall]:
    """``calls`` requests of ``len(lengths)`` users each, every one holding
    the same multiset of history lengths ``lengths``, in an order per call
    drawn from ``layout_seed``: every seed runs the same calls' sizes in the
    same sequence. ``generator`` (the run's seed, on the card) draws every
    history: mode ``popular``'s ids distinct within a user and by
    ``weights``, the other modes uniform, ratings uniform integers in
    ``ratings``. Drawn in chunks of users on the generator's device, then
    brought to the host call by call."""
    dev = generator.device
    layout = np.random.default_rng(layout_seed)
    per_call = [lengths[layout.permutation(len(lengths))]
                for _ in range(calls)]
    users = len(lengths)
    others = [d for d in range(len(shape)) if d != mode]
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    step = max(1, chunk_users // users)
    out = []
    for lo in range(0, calls, step):
        group = per_call[lo:lo + step]
        lens = torch.as_tensor(np.concatenate(group), device=dev)
        n = int(lens.sum())
        cols = [_without_replacement(generator, w, lens) if d == popular
                else torch.randint(0, shape[d], (n,), generator=generator,
                                   device=dev, dtype=torch.int32)
                for d in others]
        vals = torch.randint(ratings[0], ratings[1] + 1, (n,),
                             generator=generator, device=dev,
                             dtype=torch.int32).to(torch.float32)
        sizes = [int(x.sum()) for x in group]
        idx = torch.stack(cols, dim=1)
        distinct = [sum(int((torch.bincount(part[:, c].long(),
                                            minlength=shape[d]) > 0).sum())
                        for c, d in enumerate(others))
                    for part in torch.split(idx, sizes)]
        idx_h, vals_h = idx.cpu().numpy(), vals.cpu().numpy()
        at = 0
        for x, size, k in zip(group, sizes, distinct):
            offsets = np.concatenate([[0], np.cumsum(x)])
            out.append(FoldinCall(idx_h[at:at + size], vals_h[at:at + size],
                                  offsets, k))
            at += size
    return out


class TopkPool:
    """``calls`` top-k requests of ``batch`` queries, held on the host as
    one (calls, batch) int64 array per fixed mode; ``pool[k]`` is call k's
    ``{mode: (batch,) indices}``."""

    def __init__(self, fixed: Dict[int, np.ndarray]):
        self.fixed = fixed

    def __len__(self) -> int:
        return len(next(iter(self.fixed.values())))

    def __getitem__(self, k: int) -> Dict[int, np.ndarray]:
        return {d: a[k] for d, a in self.fixed.items()}


def topk_pool(generator: torch.Generator, shape: Sequence[int],
              target: int, calls: int, batch: int, popular: int,
              weights: np.ndarray, chunk_calls: int = 2048) -> TopkPool:
    """Every mode but ``target`` fixed in each query: mode ``popular``
    drawn by ``weights`` (with replacement: a user asks again), the others
    uniform; drawn on the generator's device in chunks of calls, kept on
    the host."""
    dev = generator.device
    cdf = torch.cumsum(torch.as_tensor(weights, dtype=torch.float64,
                                       device=dev), 0)
    fixed = {d: np.empty((calls, batch), np.int64)
             for d in range(len(shape)) if d != target}
    for lo in range(0, calls, chunk_calls):
        n = min(chunk_calls, calls - lo) * batch
        for d, out in fixed.items():
            if d == popular:
                u = torch.rand(n, generator=generator, device=dev,
                               dtype=torch.float64) * cdf[-1]
                a = torch.searchsorted(cdf, u).clamp_(max=shape[d] - 1)
            else:
                a = torch.randint(0, shape[d], (n,), generator=generator,
                                  device=dev)
            out[lo:lo + n // batch] = a.reshape(-1, batch).cpu().numpy()
    return TopkPool(fixed)
