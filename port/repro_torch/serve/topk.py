"""Top-k item retrieval: blocked matmul and a streaming top-k merge.

For a CP model the scores of every item j for one query (user i at context
k, say) factor through one R-vector,

    s_j = Σ_r U[i,r] W[k,r] V[j,r] = V @ q,   q = U[i] ⊙ W[k],

so retrieval is one matvec against the item factor. The full (B, J) score
matrix is never formed: the item factor is read in blocks of rows, and
each block's (B, block) scores are merged into a running (B, k) top-k by
``torch.topk`` over the concatenation, in Θ(B·(k + block)) memory whatever
J is. Both links are monotone, so the merge runs in model space and the
link is applied to the k winners only. This is plain ``torch.matmul`` and
``torch.topk``, as the reference's is plain ``jnp`` outside any kernel.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.utils import round_up
from repro_torch.serve.model import apply_link


def query_rows(factors: Sequence[torch.Tensor], fixed: Mapping[int, object]
               ) -> torch.Tensor:
    """(B, R) query vectors: the Hadamard product over the fixed modes.

    ``fixed`` maps a mode to (B,) int indices into its frozen factor or to
    explicit (B, R) rows (fresh fold-in output, say, in no factor)."""
    if not fixed:
        raise ValueError("query_rows needs at least one fixed mode")
    q = None
    for d in sorted(fixed):
        f = factors[d]
        v = torch.as_tensor(fixed[d], device=f.device)
        rows = v.to(f.dtype) if v.dim() == 2 else f[v.long()]
        q = rows if q is None else q * rows
    return q


def topk_over_mode(item_factor: torch.Tensor, queries: torch.Tensor, k: int,
                   block_rows: int = 4096, link: str = "identity"):
    """Streaming blocked top-k: ``(scores (B, k), indices (B, k) int32)``,
    scores descending per row, ``link`` applied to the winners.

    ``item_factor`` is the (J, R) frozen factor of the retrieved mode,
    ``queries`` the (B, R) query vectors, ``k`` clamped to J. Every block
    holds ``block_rows`` rows: the last one's rows past J score the float
    minimum, so they can never win. No host synchronisation (the engine
    captures this in a CUDA graph)."""
    j = int(item_factor.shape[0])
    k = min(int(k), j)
    block = min(int(block_rows), round_up(j, 8))
    b = queries.shape[0]
    dev = queries.device
    neg = torch.finfo(queries.dtype).min
    vals = torch.full((b, k), neg, dtype=queries.dtype, device=dev)
    idx = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for lo in range(0, j, block):
        s = queries @ item_factor[lo:lo + block].T           # (B, <= block)
        if s.shape[1] < block:
            s = torch.nn.functional.pad(s, (0, block - s.shape[1]),
                                        value=neg)
        gidx = torch.arange(lo, lo + block, dtype=torch.int32, device=dev)
        cat_v = torch.cat([vals, s], dim=1)
        cat_i = torch.cat([idx, gidx.expand(b, block)], dim=1)
        vals, sel = torch.topk(cat_v, k, dim=1)
        idx = torch.gather(cat_i, 1, sel)
    return apply_link(vals, link), idx
