"""Single-device ingest of a completion dataset.

``CompletionDataset`` shuffles the tensor, builds the CCSR bucket
pattern of every mode once (the Ω pattern does not change across sweeps)
and derives ``omega``, the Ω indicator, through ``with_values`` so that it
shares those patterns with the data tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import synthetic
from repro_torch.sparse.ccsr import bucket_pattern


class CompletionDataset:

    def __init__(self, st: SparseTensor, generator: torch.Generator,
                 block_rows: int = 8):
        tensor = synthetic.shuffle_and_pad(st, generator, num_shards=1)
        for mode in range(tensor.ndim):
            tensor.attach_pattern(mode, block_rows,
                                  bucket_pattern(tensor, mode, block_rows))
        self.block_rows = block_rows
        self.tensor = tensor
        self.omega = tensor.with_values(torch.ones_like(tensor.values))
