"""SparseTensor: padded-COO sparse tensor with an explicit validity mask.

``indices (cap, ndim) int32``, ``values (cap,)`` (or ``(cap, R)`` with a
trailing dense axis, as pairwise-contraction intermediates have) and
``valid (cap,) bool``. Padded entries carry index 0 and value 0, so gathers
stay in bounds and linear reductions are unaffected; the mask guards the
nonlinear paths. Storage is Θ(cap) = Θ(m), never Θ(rows).

The CCSR row-block bucket patterns (``repro_torch.sparse.ccsr``) are cached
per ``(mode, block_rows)`` and shared by reference across ``with_values``
derivations: the Ω pattern is the same, only the values differ. The bucket
values gathered through a pattern are cached per tensor: each instance
gathers its own values once per ``(mode, block_rows)``, and again only
after its ``values`` or ``valid`` change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.utils import delinearize, linearize, pad_axis, round_up


@dataclasses.dataclass
class SparseTensor:
    indices: torch.Tensor  # (cap, ndim) int32
    values: torch.Tensor   # (cap,)
    valid: torch.Tensor    # (cap,) bool
    shape: Tuple[int, ...]
    nnz: Optional[int] = None          # global nonzero count hint
    sorted_mode: Optional[int] = None  # mode by which entries are sorted
    # nonzero-row count per mode, streamed at ingest (a planner hint)
    nnz_rows: Optional[Tuple[int, ...]] = None
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
    def dense_dim(self) -> Optional[int]:
        """Width of the trailing dense axis of ``values``, None without one."""
        return None if self.values.dim() == 1 else self.values.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        """(cap,) validity mask."""
        return self.valid

    def _vmask(self) -> torch.Tensor:
        return self.valid if self.values.dim() == 1 else self.valid[:, None]

    def masked_values(self) -> torch.Tensor:
        return torch.where(self._vmask(), self.values, 0)

    def count_valid(self) -> torch.Tensor:
        return torch.sum(self.valid)

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
                 pad_multiple: int = 1, device=None) -> "SparseTensor":
        """Padded COO from (nnz, ndim) indices and (nnz,) or (nnz, R)
        values, on ``device`` (None keeps the inputs' device). ``cap``
        defaults to nnz rounded up to ``pad_multiple``."""
        indices = torch.as_tensor(indices, dtype=torch.int32, device=device)
        values = torch.as_tensor(values, device=indices.device)
        nnz = int(indices.shape[0])
        if cap is None:
            cap = round_up(max(nnz, 1), pad_multiple)
        valid = torch.arange(cap, device=indices.device) < nnz
        indices = pad_axis(indices, cap, axis=0, value=0)
        values = pad_axis(values, cap, axis=0, value=0)
        return cls(indices, values, valid, tuple(int(s) for s in shape), nnz)

    @classmethod
    def random(cls, generator: torch.Generator, shape, nnz: int,
               cap: Optional[int] = None, dtype=torch.float32, low=-1.0,
               high=1.0) -> "SparseTensor":
        """Uniform-random sparse tensor (the paper's ``fill_sp_random``) on
        the generator's device: indices i.i.d. uniform per mode (duplicates
        possible), values uniform in [low, high)."""
        dev = generator.device
        indices = torch.stack(
            [torch.randint(0, int(s), (nnz,), generator=generator,
                           device=dev, dtype=torch.int32) for s in shape],
            dim=1)
        values = torch.rand(nnz, generator=generator, device=dev,
                            dtype=dtype) * (high - low) + low
        return cls.from_coo(indices, values, shape, cap=cap)

    @classmethod
    def from_buckets(cls, buckets) -> "SparseTensor":
        """The padded COO of a bucket view's slots (``RowBlockBuckets``,
        padding slots invalid), in bucket order, with that view cached as
        its ``row_buckets(buckets.mode, buckets.block_rows)``: what the
        planner reads runs over the view as it is, gathering nothing."""
        nb, c, nd = buckets.indices.shape
        st = cls(buckets.indices.reshape(nb * c, nd),
                 buckets.values.reshape(nb * c),
                 buckets.valid.reshape(nb * c), tuple(buckets.shape))
        st._bucket_cache = {
            (int(buckets.mode), int(buckets.block_rows)):
            (st.values, st.values._version, st.valid, st.valid._version,
             buckets)}
        return st

    # -- transformations ------------------------------------------------------
    def sort_by_mode(self, mode: int) -> "SparseTensor":
        """Sort entries so that ``indices[:, mode]`` is non-decreasing, with
        padded entries moved to the end (they sort to ``shape[mode]``)."""
        key = torch.where(self.valid, self.indices[:, mode],
                          self.shape[mode])
        perm = torch.sort(key, stable=True).indices
        return SparseTensor(self.indices[perm], self.values[perm],
                            self.valid[perm], self.shape, self.nnz,
                            sorted_mode=mode, nnz_rows=self.nnz_rows)

    def with_values(self, values: torch.Tensor) -> "SparseTensor":
        """Same pattern, new values (zeroed on padding). Shares the cached
        bucket patterns, not the gathered bucket values."""
        vmask = self.valid if values.dim() == 1 else self.valid[:, None]
        return SparseTensor(self.indices, torch.where(vmask, values, 0),
                            self.valid, self.shape, self.nnz,
                            self.sorted_mode, self.nnz_rows,
                            _pattern_cache=self._pattern_cache)

    def astype(self, dtype) -> "SparseTensor":
        return SparseTensor(self.indices, self.values.to(dtype), self.valid,
                            self.shape, self.nnz, self.sorted_mode,
                            self.nnz_rows, _pattern_cache=self._pattern_cache)

    def row_buckets(self, mode: int, block_rows: int):
        """Cached CCSR bucket view over ``mode`` (``repro_torch.sparse.ccsr``).

        The pattern is built once per ``(mode, block_rows)`` (normally at
        ingest, ``data.pipeline.CompletionDataset``) and reused across
        ``with_values`` derivations. The values are gathered through it once
        per tensor: later calls return the same view while ``values`` and
        ``valid`` are the same tensors at the same version (an in-place
        write bumps ``_version`` and so brings a fresh gather)."""
        if self.dense_dim is not None:
            # checked before the cache: a with_values derivation can widen
            # the values while sharing its scalar sibling's patterns
            raise ValueError("values with a trailing dense axis have no "
                             "bucket view")
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
        out = torch.zeros(self.shape + self.values.shape[1:],
                          dtype=self.values.dtype, device=self.device)
        idx = tuple(self.indices[:, d].long() for d in range(self.ndim))
        return out.index_put_(idx, self.masked_values(), accumulate=True)

    def transpose(self, perm: Sequence[int]) -> "SparseTensor":
        """Permute the sparse modes (paper Fig. 4 'transpose')."""
        perm = tuple(perm)
        rows = (None if self.nnz_rows is None
                else tuple(self.nnz_rows[p] for p in perm))
        return SparseTensor(self.indices[:, list(perm)], self.values,
                            self.valid, tuple(self.shape[p] for p in perm),
                            self.nnz, None, rows)

    def reshape(self, new_shape: Sequence[int]) -> "SparseTensor":
        """Reshape keeping the row-major global order (paper Fig. 4
        'reshape'); padding slots keep index 0."""
        new_shape = tuple(int(s) for s in new_shape)
        if math.prod(new_shape) != math.prod(self.shape):
            raise ValueError(f"reshape {self.shape} -> {new_shape}: size "
                             f"mismatch")
        lin = torch.where(self.valid, linearize(self.indices, self.shape), 0)
        new_idx = torch.where(self.valid[:, None],
                              delinearize(lin, new_shape), 0)
        return SparseTensor(new_idx, self.values, self.valid, new_shape,
                            self.nnz, None)

    def scale(self, alpha) -> "SparseTensor":
        return self.with_values(self.values * alpha)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        """Sparse + sparse over the same pattern (the same indices)."""
        if self.shape != other.shape:
            raise ValueError(f"add: shapes {self.shape} and {other.shape}")
        return self.with_values(self.values + other.values)

    def reduce_mode(self, mode: int,
                    num_segments: Optional[int] = None) -> torch.Tensor:
        """``einsum('ijk->i')``-style sum of the valid entries onto one mode
        (a dense output), for scalar or trailing-dense values. Entries whose
        row is at or past ``num_segments`` are dropped, as the reference's
        segment sum drops them."""
        num_segments = num_segments or self.shape[mode]
        vals = self.masked_values()
        ids = self.indices[:, mode].long()
        inside = ids < num_segments
        keep = inside if vals.dim() == 1 else inside[:, None]
        out = torch.zeros((num_segments,) + vals.shape[1:], dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, torch.where(inside, ids, 0),
                              torch.where(keep, vals, 0))

    def sum(self) -> torch.Tensor:
        return torch.sum(self.masked_values())

    def norm(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(self.masked_values())))
