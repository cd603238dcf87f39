"""All-at-once sparse MTTKRP over the padded COO (gather → product →
``index_add_``). The main path runs the bucketed kernel instead; this is
the independent second oracle the tests hold it against."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.sparse_tensor import SparseTensor


def mttkrp(st: SparseTensor, factors: Sequence[torch.Tensor],
           mode: int) -> torch.Tensor:
    """y[i, r] = Σ_{n: idx[n, mode] = i} v_n Π_{d≠mode} A_d[idx[n, d], r]."""
    prod = st.masked_values()[:, None]
    for d in range(st.ndim):
        if d != mode:
            prod = prod * factors[d][st.indices[:, d]]
    out = torch.zeros(st.shape[mode], prod.shape[1], dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, st.indices[:, mode].long(), prod)
