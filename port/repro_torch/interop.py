"""Carry tensors and factors across from the JAX package.

The functions take numpy arrays (``np.asarray`` of the JAX package's
arrays) so this module needs neither jax nor ``repro``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor


def sparse_from_numpy(indices, values, valid, shape,
                      device="cuda") -> SparseTensor:
    """SparseTensor from padded-COO arrays, entries kept in their order."""
    valid = np.asarray(valid, dtype=bool)
    return SparseTensor(
        torch.tensor(np.asarray(indices, np.int32), device=device),
        torch.tensor(np.asarray(values), device=device),
        torch.tensor(valid, device=device),
        tuple(int(s) for s in shape),
        int(valid.sum()))


def factors_from_numpy(arrays: Sequence,
                       device="cuda") -> List[torch.Tensor]:
    return [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
            for a in arrays]
