"""SparseTensor: padded-COO sparse tensor with an explicit validity mask.

``indices (cap, ndim) int32``, ``values (cap,)`` and ``valid (cap,) bool``. Padded entries carry index 0
and value 0, so gathers stay in bounds and linear reductions are unaffected;
the mask guards the nonlinear paths. Storage is Θ(cap) = Θ(m), never
Θ(rows).

The CCSR row-block bucket patterns (``repro_torch.sparse.ccsr``) are cached
per ``(mode, block_rows)`` and shared by reference across ``with_values``
derivations: the Ω pattern is the same, only the values differ. The bucket
values gathered through a pattern are cached per tensor: each instance
gathers its own values once per ``(mode, block_rows)``, and again only
after its ``values`` or ``valid`` change.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.utils import pad_axis


@dataclasses.dataclass
class SparseTensor:
    indices: torch.Tensor  # (cap, ndim) int32
    values: torch.Tensor   # (cap,)
    valid: torch.Tensor    # (cap,) bool
    shape: Tuple[int, ...]
    nnz: Optional[int] = None          # global nonzero count hint
    sorted_mode: Optional[int] = None  # mode by which entries are sorted
    _pattern_cache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (mode, block_rows) -> (values, values._version, valid, valid._version,
    # RowBlockBuckets): this instance's gathered bucket views
    _bucket_cache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (valid, valid._version, positions of the valid entries)
    _valid_positions: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- basic properties ---------------------------------------------------
    @property
    def cap(self) -> int:
        return self.indices.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def mask(self) -> torch.Tensor:
        """(cap,) validity mask."""
        return self.valid

    def masked_values(self) -> torch.Tensor:
        return torch.where(self.valid, self.values, 0)

    def valid_positions(self) -> torch.Tensor:
        """(count,) int64 slots of the valid entries, in slot order. Found
        once per ``valid`` tensor (``torch.nonzero`` waits for the device)
        and kept while ``valid`` is the same tensor at the same version."""
        hit = self._valid_positions
        if (hit is not None and hit[0] is self.valid
                and hit[1] == self.valid._version):
            return hit[2]
        pos = torch.nonzero(self.valid).squeeze(1)
        self._valid_positions = (self.valid, self.valid._version, pos)
        return pos

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_coo(cls, indices, values, shape, cap: Optional[int] = None,
                 device=None) -> "SparseTensor":
        indices = torch.as_tensor(indices, dtype=torch.int32, device=device)
        values = torch.as_tensor(values, device=indices.device)
        nnz = int(indices.shape[0])
        if cap is None:
            cap = max(nnz, 1)
        valid = torch.arange(cap, device=indices.device) < nnz
        indices = pad_axis(indices, cap, axis=0, value=0)
        values = pad_axis(values, cap, axis=0, value=0)
        return cls(indices, values, valid, tuple(int(s) for s in shape), nnz)

    # -- transformations ------------------------------------------------------
    def sort_by_mode(self, mode: int) -> "SparseTensor":
        """Sort entries so that ``indices[:, mode]`` is non-decreasing, with
        padded entries moved to the end (they sort to ``shape[mode]``)."""
        key = torch.where(self.valid, self.indices[:, mode],
                          self.shape[mode])
        perm = torch.sort(key, stable=True).indices
        return SparseTensor(self.indices[perm], self.values[perm],
                            self.valid[perm], self.shape, self.nnz,
                            sorted_mode=mode)

    def with_values(self, values: torch.Tensor) -> "SparseTensor":
        """Same pattern, new values (zeroed on padding). Shares the cached
        bucket patterns, not the gathered bucket values."""
        return SparseTensor(self.indices, torch.where(self.valid, values, 0),
                            self.valid, self.shape, self.nnz,
                            self.sorted_mode,
                            _pattern_cache=self._pattern_cache)

    def row_buckets(self, mode: int, block_rows: int):
        """Cached CCSR bucket view over ``mode`` (``repro_torch.sparse.ccsr``).

        The pattern is built once per ``(mode, block_rows)`` (normally at
        ingest, ``data.pipeline.CompletionDataset``) and reused across
        ``with_values`` derivations. The values are gathered through it once
        per tensor: later calls return the same view while ``values`` and
        ``valid`` are the same tensors at the same version (an in-place
        write bumps ``_version`` and so brings a fresh gather)."""
        if self._pattern_cache is None:
            self._pattern_cache = {}
        if self._bucket_cache is None:
            self._bucket_cache = {}
        key = (int(mode), int(block_rows))
        hit = self._bucket_cache.get(key)
        if (hit is not None and hit[0] is self.values
                and hit[1] == self.values._version and hit[2] is self.valid
                and hit[3] == self.valid._version):
            return hit[4]
        pat = self._pattern_cache.get(key)
        if pat is None:
            from repro_torch.sparse.ccsr import bucket_pattern
            pat = bucket_pattern(self, mode, block_rows)
            self._pattern_cache[key] = pat
        buckets = pat.gather(self)
        self._bucket_cache[key] = (self.values, self.values._version,
                                   self.valid, self.valid._version, buckets)
        return buckets

    def attach_pattern(self, mode: int, block_rows: int, pattern) -> None:
        """Install an externally built bucket pattern so later
        ``row_buckets`` calls skip the build."""
        if self._pattern_cache is None:
            self._pattern_cache = {}
        self._pattern_cache[(int(mode), int(block_rows))] = pattern

    def todense(self) -> torch.Tensor:
        """Materialize (small tensors / tests only); duplicates are summed."""
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.device)
        idx = tuple(self.indices[:, d].long() for d in range(self.ndim))
        return out.index_put_(idx, self.masked_values(), accumulate=True)
