"""Launch shapes of the CUDA kernels, the per-family tile table, and the
in-bucket scatter primitive's plain form.

A :class:`KernelTile` carries what the CUDA kernels really take at launch:

``block_rows``  — the CCSR bucket granularity the tuner evaluates (recorded,
                  as in the reference; the kernels honour the
                  ``block_rows`` of whatever bucket view they are given);
``threads``     — threads per CTA (a multiple of 32, at most
                  ``MAX_THREADS``, which the kernels are compiled for);
``per_thread``  — slots a thread takes per step: the bucketed body's
                  ``SLOTS`` (``csrc/bucket_rows.cuh``) and TTTP's ``NZ``
                  (``csrc/tttp.cu``), template depths compiled for
                  ``PER_THREAD_DEPTHS``;
``accum_dtype`` — the accumulator, ``"float32"`` or ``"float64"`` (the
                  reference's ``KernelTile.accum_dtype`` takes both):
                  float32 and bfloat16 operands accumulate in the tile's
                  type, float64 in their own instantiations
                  (``csrc/*_f32_acc64.cu``, ``csrc/*_bf16_acc64.cu``);
                  float64 operands accumulate in float64 whichever the
                  tile names (:meth:`KernelTile.accumulator`). The field
                  picks the instantiation a launch takes, so it is part of
                  a tile's equality and hash: the plan cache keys on it.

Tiles are frozen, hashable and round-trip through JSON (the on-disk plan
cache, ``planner.tuner``). The process-wide table below is what
``kernels.ops`` resolves when a caller passes no tile; the tuner installs
measured winners into it. ``DEFAULT_TILE`` is the launch every kernel made
before tiles were tuned: 256 threads, 2 slots per thread.

The reference's one-hot and segmented scatter schedules (and its
``onehot_break_even``) are not tile fields here: the CUDA kernels scatter
with running sums flushed at row changes (``csrc/scatter_rows.cuh``).
:func:`scatter_rows` is the plain PyTorch form of the reference's in-bucket
scatter-add with both of its schedules; the plain versions in
``kernels.ref`` accumulate through it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

FAMILIES = ("tttp", "mttkrp", "cg_matvec")

# threads per CTA the kernels are compiled for (MAX_THREADS in
# csrc/common.cuh, their __launch_bounds__)
MAX_THREADS = 256
# the per-thread depths the kernels are instantiated for (valid_depth in
# csrc/common.cuh)
PER_THREAD_DEPTHS = (1, 2, 4)

_SCHEDULES = ("onehot", "segmented")
# the accumulators a tile may name, and their short labels
ACCUM_DTYPES = {"float32": "f32", "float64": "f64"}


@dataclasses.dataclass(frozen=True)
class KernelTile:
    """One launch shape of a kernel family (see the module docstring)."""
    block_rows: int = 8
    threads: int = 256
    per_thread: int = 2
    accum_dtype: str = "float32"

    def __post_init__(self):
        if self.accum_dtype not in ACCUM_DTYPES:
            raise ValueError(
                f"accum_dtype {self.accum_dtype!r} not in "
                f"{tuple(ACCUM_DTYPES)}: no instantiation sums in it (the "
                f"CUDA kernels accumulate in float32 only or in float64)")
        if self.block_rows < 1:
            raise ValueError("block_rows must be positive")
        if self.threads < 32 or self.threads % 32 or \
                self.threads > MAX_THREADS:
            raise ValueError(f"threads {self.threads}: a multiple of 32 "
                             f"from 32 to {MAX_THREADS}")
        if self.per_thread not in PER_THREAD_DEPTHS:
            raise ValueError(f"per_thread {self.per_thread} not in "
                             f"{PER_THREAD_DEPTHS}")

    def short(self) -> str:
        """Compact label for spans and plan records: br8.t256.p2.f32
        (``.f64`` for a float64 accumulator)"""
        return (f"br{self.block_rows}.t{self.threads}.p{self.per_thread}"
                f".{ACCUM_DTYPES[self.accum_dtype]}")

    def accumulator(self, dtype: torch.dtype) -> torch.dtype:
        """The type a launch on ``dtype`` operands sums in: float64 for
        float64 operands or a float64 tile, float32 otherwise."""
        if dtype == torch.float64 or self.accum_dtype == "float64":
            return torch.float64
        return torch.float32

    def widens(self, dtype: torch.dtype) -> bool:
        """True when the tile sums ``dtype`` operands in a wider type than
        their own instantiation does (float64 over float32 or bfloat16)."""
        return self.accumulator(dtype) == torch.float64 and \
            dtype != torch.float64

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "KernelTile":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


# ---------------------------------------------------------------------------
# process-wide per-family tile table (the tuner's output seam)
# ---------------------------------------------------------------------------

DEFAULT_TILE = KernelTile()

_TILE_TABLE: Dict[str, KernelTile] = {f: DEFAULT_TILE for f in FAMILIES}


def current_tile(family: str) -> KernelTile:
    """The tile ``kernels.ops`` resolves for ``family`` when the caller
    passes none: the default until ``planner.tuner`` installs a measured
    winner."""
    return _TILE_TABLE[family]


def set_tile(family: str, tile: KernelTile) -> None:
    if family not in _TILE_TABLE:
        raise KeyError(f"unknown kernel family {family!r}; "
                       f"families: {FAMILIES}")
    _TILE_TABLE[family] = tile


def reset_tiles() -> None:
    for f in FAMILIES:
        _TILE_TABLE[f] = DEFAULT_TILE


def scatter_rows(prod: torch.Tensor, key: torch.Tensor, block_rows: int,
                 schedule: str, acc_dtype: torch.dtype) -> torch.Tensor:
    """Scatter-add ``prod`` (..., C, R) rows into (..., block_rows, R) rows
    by ``key`` (..., C); leading dimensions are independent buckets.

    Slots whose key is not in ``[0, block_rows)`` add nothing. The one-hot
    schedule takes keys in any order. The segmented schedule needs ``key``
    non-decreasing with padding slots mapped past the valid range
    (``key == block_rows``): callers build
    ``key = where(valid, local_row, block_rows)``. Monotonicity is what lets
    it read "rows with key ≤ i" as a prefix of the cumulative sum."""
    rows = torch.arange(block_rows, device=key.device, dtype=key.dtype)
    if schedule == "onehot":
        onehot = (key[..., None, :] == rows[:, None]).to(acc_dtype)
        return onehot @ prod.to(acc_dtype)
    if schedule != "segmented":
        raise ValueError(f"scatter schedule {schedule!r} not in {_SCHEDULES}")
    csum = torch.cumsum(prod.to(acc_dtype), dim=-2)          # (..., C, R)
    ends = (key[..., None, :] <= rows[:, None]).sum(dim=-1)  # (..., block_rows)
    last = torch.clamp(ends - 1, min=0)[..., None].expand(
        *ends.shape, csum.shape[-1])
    e = torch.where((ends > 0)[..., None], torch.gather(csum, -2, last), 0)
    prev = torch.cat([torch.zeros_like(e[..., :1, :]), e[..., :-1, :]],
                     dim=-2)
    return e - prev
