"""Execution context of the completion algorithms, over
``torch.distributed`` process groups (the Cyclops role; the reference plays
it with ``shard_map``).

The algorithms are written against an :class:`AxisCtx`, so the same code
runs on one device (:data:`LOCAL`, every reduction the identity) and over
a grid of ranks laid out by a :class:`DistLayout`:

* nonzeros sharded over the data axes (several data axes flatten into
  one group), the paper's distribution of the observed entries;
* factor matrices column-sharded over the model axis (the paper's
  H-slicing of R as an axis of the grid), replicated over the data axes;
* TTTP: local partial inner products, then ``psum_model``; MTTKRP: a local
  segment sum, then ``psum_data``; CG's row-wise dots: ``psum_model``.

Each psum is an ``all_reduce`` over the axis's group
(``core.collectives``, which counts calls and bytes). ``tttp_ctx``,
``mttkrp_ctx`` and ``reduce_mode_ctx`` are shims over the planner
(``repro_torch.planner``), as in the reference: the contraction is
classified, planned with the communication terms the ctx implies (cached
on its static signature), and dispatched with the ctx's psums; ``path``
forces a candidate.

Also here: the paper's butterfly sparse all-reduce (Fig. 1,
:func:`sparse_allreduce_butterfly`) and factors with their ROWS sharded
over the data axes (Fig. 2, :func:`multilinear_rowsharded`,
:func:`mttkrp_rowsharded`): per column slice an ``all_gather`` of the
rows, the TTTP kernel or the bucketed MTTKRP kernel on the rank's
nonzeros, and for MTTKRP a ``reduce_scatter`` of equal row blocks to their
owners.

One departure: ``path=None`` is the paper's all-at-once schedule, pinned
(``all_at_once`` for TTTP and MTTKRP: the TTTP kernel and the bucketed
MTTKRP kernel over the tensor's cached view; ``segment`` for the
reduction). The reference's ``None`` asks the §5.3 cost model, which on
small, fairly dense tensors ranks the pairwise KR-first MTTKRP first and so
takes the solvers off the kernel, and changes their summation order, at
test sizes; at the sizes the kernel is for (``chip_smoke.py``'s 80 M
nonzeros) it ranks ``all_at_once`` first as well.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
from repro_torch.core.sparse_tensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """The axes an algorithm runs under: ``data`` (an axis name, a tuple of
    names or None) and ``model`` (a name or None), their ``sizes`` and this
    rank's ``coords`` (``(name, int)`` pairs, host ints). ``groups`` holds
    the (data, model) process groups. Equality and hashing see the names
    and sizes only, so a ctx keys the planner's cache as the reference's
    does. :data:`LOCAL` names no axis: both psums are identities."""

    data: Optional[object] = None
    model: Optional[str] = None
    sizes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[Tuple[str, int], ...] = dataclasses.field(
        default=(), compare=False)
    groups: Tuple = dataclasses.field(default=(None, None), compare=False,
                                      repr=False)

    def _data_names(self) -> Tuple[str, ...]:
        if self.data is None:
            return ()
        return self.data if isinstance(self.data, tuple) else (self.data,)

    def _size(self, name: str) -> int:
        sizes = dict(self.sizes)
        if name not in sizes:
            raise ValueError(
                f"axis {name!r} of {self!r} has no size: build the ctx with "
                f"DistLayout(...).ctx inside an initialised process group")
        return sizes[name]

    def data_size(self) -> int:
        return math.prod(self._size(n) for n in self._data_names())

    def model_size(self) -> int:
        return 1 if self.model is None else self._size(self.model)

    def model_index(self) -> int:
        return 0 if self.model is None else dict(self.coords)[self.model]

    def data_index(self) -> int:
        """This rank's index among the data shards (the data axes' coords
        flattened row-major in the order of ``data``)."""
        coords = dict(self.coords)
        idx = 0
        for n in self._data_names():
            idx = idx * self._size(n) + coords[n]
        return idx

    @property
    def data_group(self):
        return self.groups[0]

    @property
    def model_group(self):
        return self.groups[1]

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        if self.data is None:
            return x
        return coll.all_reduce(x, self.data_group)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model is None:
            return x
        return coll.all_reduce(x, self.model_group)


LOCAL = AxisCtx()

# (grid, axes, data_axes, model_axis, default group) -> {rank: (data group,
# model group)}; a new default group (a new init) makes new groups
_GROUPS: Dict[Tuple, Dict[int, Tuple]] = {}


@dataclasses.dataclass(frozen=True)
class DistLayout:
    """A grid of ranks (``grid``, axis names ``axes``), laid out row-major
    as ``jax.make_mesh`` lays out devices, with the nonzeros sharded over
    ``data_axes`` and the factor columns over ``model_axis``; any other
    axis holds replicas. ``rank`` defaults to ``torch.distributed``'s.

    In place of the reference's ``PartitionSpec``s it gives each rank its
    slice: :meth:`shard` (its block of the nonzero slots),
    :meth:`factor_cols` (its factor columns), :meth:`slice` and
    :meth:`gather` for any leaf by a spec (``None``, ``"data"`` or
    ``"model"`` per dim). :attr:`ctx` makes the process groups (every
    rank must call it, in the same order as its other collectives)."""

    grid: Tuple[int, ...]
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = None
    axes: Tuple[str, ...] = ("data", "model")
    rank: Optional[int] = None

    def __post_init__(self):
        grid = tuple(int(g) for g in self.grid)
        axes = tuple(self.axes)
        data_axes = (tuple(self.data_axes)
                     if not isinstance(self.data_axes, str)
                     else (self.data_axes,))
        if len(axes) != len(grid):
            raise ValueError(f"grid {grid} and axes {axes} differ in length")
        unknown = [a for a in data_axes + ((self.model_axis,)
                                           if self.model_axis else ())
                   if a not in axes]
        if unknown or not data_axes or self.model_axis in data_axes:
            raise ValueError(f"data axes {data_axes} and model axis "
                             f"{self.model_axis!r} must be distinct axes "
                             f"of {axes}")
        rank = self.rank
        if rank is None:
            rank = dist.get_rank()
        if not 0 <= rank < math.prod(grid):
            raise ValueError(f"rank {rank} outside grid {grid}")
        object.__setattr__(self, "grid", grid)
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "data_axes", data_axes)
        object.__setattr__(self, "rank", int(rank))

    # -- coordinates (host ints) -------------------------------------------
    @property
    def world_size(self) -> int:
        return math.prod(self.grid)

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for i, a in enumerate(self.axes):
            out[a] = (rank // math.prod(self.grid[i + 1:])) % self.grid[i]
        return out

    @property
    def coords(self) -> Dict[str, int]:
        return self.coords_of(self.rank)

    def _size(self, axis: str) -> int:
        return self.grid[self.axes.index(axis)]

    def _data_names(self) -> Tuple[str, ...]:
        # grid order, so the flattened index is the data group's rank
        return tuple(a for a in self.axes if a in self.data_axes)

    @property
    def data_size(self) -> int:
        return math.prod(self._size(a) for a in self._data_names())

    @property
    def data_index(self) -> int:
        c = self.coords
        idx = 0
        for a in self._data_names():
            idx = idx * self._size(a) + c[a]
        return idx

    @property
    def model_size(self) -> int:
        return 1 if self.model_axis is None else self._size(self.model_axis)

    @property
    def model_index(self) -> int:
        return 0 if self.model_axis is None else \
            self.coords[self.model_axis]

    # -- process groups ----------------------------------------------------
    def _key(self) -> Tuple:
        return (self.grid, self.axes, self.data_axes, self.model_axis,
                dist.group.WORLD)

    def _members(self, varying: Sequence[str]):
        """The rank lists of the groups whose ranks differ only in the
        axes ``varying``, in a fixed order (every rank makes every group)."""
        fixed = [a for a in self.axes if a not in varying]
        out = []
        for vals in itertools.product(*(range(self._size(a))
                                         for a in fixed)):
            want = dict(zip(fixed, vals))
            out.append([r for r in range(self.world_size)
                        if all(self.coords_of(r)[a] == v
                               for a, v in want.items())])
        return out

    def _groups(self) -> Tuple:
        mine = _GROUPS.setdefault(self._key(), {})
        if self.rank in mine:
            return mine[self.rank]
        if dist.get_world_size() != self.world_size:
            raise ValueError(f"grid {self.grid} has {self.world_size} ranks "
                             f"but the process group {dist.get_world_size()}")
        made = []
        for varying in (self._data_names(),
                        (self.model_axis,) if self.model_size > 1
                        else None):
            if varying is None:
                made.append(None)
                continue
            own = None
            for ranks in self._members(varying):
                # the whole world is the default group: no second
                # communicator for it
                g = (dist.group.WORLD if len(ranks) == self.world_size
                     else dist.new_group(ranks))
                if self.rank in ranks:
                    own = g
            made.append(own)
        mine[self.rank] = tuple(made)
        return mine[self.rank]

    @property
    def ctx(self) -> AxisCtx:
        """The ctx of this rank. A model axis of size 1 slices nothing and
        is left out (its psum would be the identity, and the fused Gram
        matvec stays legal). Makes the groups on the first call."""
        names = self._data_names()
        data = names if len(names) > 1 else names[0]
        model = self.model_axis if self.model_size > 1 else None
        sizes = tuple((a, self._size(a)) for a in self.axes)
        coords = tuple(self.coords.items())
        groups = self._groups()
        return AxisCtx(data=data, model=model, sizes=sizes, coords=coords,
                       groups=(groups[0], groups[1] if model else None))

    def barrier(self) -> None:
        # repro-lint: disable=SP103 -- the layout's grid is the whole world
        coll.barrier(None)

    # -- this rank's slices ------------------------------------------------
    def shard(self, st: SparseTensor) -> SparseTensor:
        """This rank's contiguous block of ``cap / data_size`` nonzero slots
        (copied, so the full tensor can be freed). ``nnz`` stays the global
        count hint, as under the reference's ``shard_map``."""
        p = self.data_size
        if st.cap % p:
            raise ValueError(f"capacity {st.cap} is not a multiple of the "
                             f"data-axis size {p}: shuffle_and_pad(st, gen, "
                             f"num_shards={p}) first")
        n = st.cap // p
        lo = self.data_index * n
        return SparseTensor(st.indices[lo:lo + n].clone(),
                            st.values[lo:lo + n].clone(),
                            st.valid[lo:lo + n].clone(), st.shape, st.nnz,
                            None, st.nnz_rows)

    def _block(self, n: int, axis: str) -> Tuple[int, int]:
        size, index = ((self.model_size, self.model_index) if axis == "model"
                       else (self.data_size, self.data_index))
        if n % size:
            raise ValueError(f"extent {n} is not a multiple of the {axis} "
                             f"axis size {size}")
        return index * (n // size), (index + 1) * (n // size)

    def slice(self, x: torch.Tensor, spec: Sequence[Optional[str]]
              ) -> torch.Tensor:
        """This rank's block of the logical array ``x``: dim i cut over the
        data axes (``"data"``) or the model axis (``"model"``), or whole
        (None)."""
        for dim, axis in enumerate(spec):
            if axis is None or (axis == "model" and self.model_size == 1):
                continue
            lo, hi = self._block(x.shape[dim], axis)
            x = x.narrow(dim, lo, hi - lo)
        return x.contiguous()

    def factor_cols(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's column slice of a factor on the model axis (rows
        replicated): ``R`` must be a multiple of the model-axis size."""
        return self.slice(a, (None, "model"))

    def gather(self, x: torch.Tensor, spec: Sequence[Optional[str]]
               ) -> torch.Tensor:
        """The logical array from every rank's block (the inverse of
        :meth:`slice`; collective over the groups of the sharded dims)."""
        ctx = self.ctx
        for dim, axis in enumerate(spec):
            if axis is None or (axis == "model" and ctx.model is None):
                continue
            group = ctx.model_group if axis == "model" else ctx.data_group
            moved = x.movedim(dim, 0).contiguous()
            x = coll.all_gather(moved, group).movedim(0, dim)
        return x.contiguous()


def planner_config(block_rows: Optional[int] = None):
    """The process-wide ``PlannerConfig`` at bucket granularity
    ``block_rows`` (None keeps the default's)."""
    from repro_torch.planner.config import default_config
    cfg = default_config()
    if block_rows is None or block_rows == cfg.block_rows:
        return cfg
    return dataclasses.replace(cfg, block_rows=block_rows)


def tttp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
             ctx: AxisCtx = LOCAL, path: Optional[str] = None) -> SparseTensor:
    """TTTP under ``ctx`` through the planner; the psum over the model axis
    adds the partial products of column-sliced factors (inside dispatch).
    ``path`` forces a planner candidate (None: ``all_at_once``)."""
    from repro_torch.planner import planned_tttp
    return planned_tttp(st, factors, path=path or "all_at_once", ctx=ctx)


def mttkrp_ctx(st: SparseTensor, factors: Sequence[Optional[torch.Tensor]],
               mode: int, ctx: AxisCtx = LOCAL,
               block_rows: Optional[int] = None,
               path: Optional[str] = None) -> torch.Tensor:
    """Classic MTTKRP under ``ctx`` through the planner, psum over the data
    axes. ``block_rows`` is the bucket granularity of the cached view the
    bucketed kernel reads (None: the planner config's). ``path`` forces a
    planner candidate (None: ``all_at_once``, the bucketed kernel).
    Output (shape[mode], R_local): replicated over the data axes,
    column-sharded over the model axis."""
    from repro_torch.planner import planned_mttkrp
    return planned_mttkrp(st, factors, mode, path=path or "all_at_once",
                          ctx=ctx, config=planner_config(block_rows))


def rowdot_ctx(a: torch.Tensor, b: torch.Tensor,
               ctx: AxisCtx = LOCAL) -> torch.Tensor:
    """Row-wise inner products of column-sharded (rows, R_local)
    matrices."""
    return ctx.psum_model((a * b).sum(dim=-1))


def reduce_mode_ctx(st: SparseTensor, mode: int, ctx: AxisCtx = LOCAL,
                    path: Optional[str] = None) -> torch.Tensor:
    """``einsum('ijk->i')``-style reduction of the valid entries onto
    ``mode`` through the planner (None: ``segment``, a segment sum by
    ``index_add_``), psum over the data axes."""
    from repro_torch.planner import planned_reduce
    return planned_reduce(st, (mode,), path=path or "segment", ctx=ctx)


def sqnorm_ctx(a: torch.Tensor, ctx: AxisCtx = LOCAL) -> torch.Tensor:
    return ctx.psum_model(torch.sum(torch.square(a)))


# ---------------------------------------------------------------------------
# butterfly sparse all-reduce (paper Fig. 1), k = 2
# ---------------------------------------------------------------------------

def sparse_allreduce_butterfly(st: SparseTensor, group=None) -> SparseTensor:
    """All-reduce sparse blocks whose patterns differ from rank to rank
    over ``group`` (None: the world): recursive halving over mode-0
    coordinate ranges (a reduce-scatter, each step's union summed by
    ``sparse.ops.sparse_add_union``), then recursive doubling (an
    all-gather; the owned ranges are disjoint, so the union is exact). Each
    step is one ``batch_isend_irecv`` with the partner ``rank ^ (1 << s)``
    in the group. Capacities are static: ``st.cap`` while halving, doubling
    back to ``size · cap``. Power-of-two groups only, as in the reference.

    Where the reference truncates a step's owned entries to ``st.cap``
    silently, this raises when they do not fit (one host read per step)."""
    from repro_torch.sparse import ops as sops
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    steps = size.bit_length() - 1
    if 1 << steps != size:
        raise ValueError(f"the butterfly needs a power-of-two group, not "
                         f"{size} ranks")
    lo, hi = 0, st.shape[0]
    cur = st
    for s in range(steps):
        mid = lo + (hi - lo) // 2
        keep_lo, keep_hi = (lo, mid) if not (rank >> s) & 1 else (mid, hi)
        rows = cur.indices[:, 0]
        mine = (rows >= keep_lo) & (rows < keep_hi) & cur.mask
        theirs = ~mine & cur.mask
        vals = cur.masked_values()
        r_idx, r_vals, r_valid = coll.exchange(
            [cur.indices, torch.where(theirs, vals, 0),
             theirs.to(torch.uint8)], rank ^ (1 << s), group)
        cur = sops.sparse_add_union(
            SparseTensor(cur.indices, torch.where(mine, vals, 0), mine,
                         cur.shape),
            SparseTensor(r_idx, r_vals, r_valid.bool(), cur.shape))
        # the union sorts valid entries first: the owned ones lead
        # the overflow check the port adds where the reference truncates: one
        # sync per butterfly step, never in a sweep or a capture
        # repro-lint: disable=JS001,JS002 -- the butterfly's overflow check
        if bool(cur.valid[st.cap:].any()):
            raise ValueError(
                f"butterfly step {s}: the owned range [{keep_lo}, {keep_hi}) "
                f"holds more than the block capacity {st.cap} entries")
        cur = SparseTensor(cur.indices[:st.cap], cur.values[:st.cap],
                           cur.valid[:st.cap], cur.shape)
        lo, hi = keep_lo, keep_hi
    out = cur
    for s in range(steps - 1, -1, -1):
        r_idx, r_vals, r_valid = coll.exchange(
            [out.indices, out.masked_values(), out.valid.to(torch.uint8)],
            rank ^ (1 << s), group)
        out = sops.sparse_add_union(
            out, SparseTensor(r_idx, r_vals, r_valid.bool(), out.shape))
    return out


# ---------------------------------------------------------------------------
# factor rows sharded over the data axes, H-sliced gathers (paper Fig. 2)
#
# ``multilinear_rowsharded`` and ``_mttkrp_rowsharded_impl`` are what the
# planner's ``rowsharded`` path dispatches onto; ``mttkrp_rowsharded`` is
# the public planner shim.
# ---------------------------------------------------------------------------

def _gather_slice(factors_local, h: int, rs: int, group, skip=None):
    """Issue the all-gathers of column slice ``h`` (``rs`` columns) of every
    present factor but ``skip``; returns the pending gathers."""
    return [None if f is None or d == skip else
            coll.all_gather(f[:, h * rs:(h + 1) * rs].contiguous(), group,
                            async_op=True)
            for d, f in enumerate(factors_local)]


def _slices(factors_local, h_slices: int) -> Tuple[int, int, int]:
    r = next(f.shape[1] for f in factors_local if f is not None)
    h = max(h_slices, 1)
    return r, h, -(-r // h)


def multilinear_rowsharded(st: SparseTensor, factors_local, ctx: AxisCtx,
                           h_slices: int = 1) -> torch.Tensor:
    """Σ_r Π_d A_d[i_d, r] per local nonzero, with the factors' ROWS
    sharded over the data axes (the paper's memory-scalable distribution):
    each column slice of ⌈R/H⌉ is all-gathered (payload Θ(I·R/H)), used by
    the TTTP kernel and dropped; slice h+1's gather is issued before slice
    h's compute, as the reference orders it."""
    from repro_torch.kernels import ops as kops
    r, h, rs = _slices(factors_local, h_slices)
    group = ctx.data_group
    ones = st.with_values(torch.ones_like(st.values))
    acc = None
    nxt = _gather_slice(factors_local, 0, rs, group)
    for k in range(h):
        cur = nxt
        if k + 1 < h:
            nxt = _gather_slice(factors_local, k + 1, rs, group)
        part = kops.tttp_values(ones, [None if p is None else p.wait()
                                       for p in cur])
        acc = part if acc is None else acc + part
    return acc


def mttkrp_rowsharded(st: SparseTensor, factors_local, mode: int,
                      ctx: AxisCtx, h_slices: int = 1) -> torch.Tensor:
    """MTTKRP with the factors' ROWS sharded over the data axes, through
    the planner's ``rowsharded`` path: per column slice, gather the
    non-target factors' columns, run the bucketed MTTKRP kernel over the
    rank's nonzeros, then reduce-scatter the output rows to their owners
    (Θ(I·R/H) transients and payloads). Output (rows_local, R)."""
    from repro_torch.planner import planned_mttkrp
    return planned_mttkrp(st, factors_local, mode, ctx=ctx, rowsharded=True,
                          h_slices=h_slices)


def _mttkrp_rowsharded_impl(st: SparseTensor, factors_local, mode: int,
                            ctx: AxisCtx, h_slices: int = 1,
                            block_rows: Optional[int] = None
                            ) -> torch.Tensor:
    """The gather / kernel / reduce-scatter behind :func:`mttkrp_rowsharded`
    (called by planner dispatch): the MTTKRP kernel over the rank's cached
    bucket view at ``block_rows`` (None: the planner config's)."""
    from repro_torch.kernels import ops as kops
    r, h, rs = _slices(factors_local, h_slices)
    n_rows = st.shape[mode]
    # the target mode's rows are sharded evenly over the data axes (the
    # target factor itself is not an operand of the contraction)
    p = ctx.data_size()
    if n_rows % p:
        raise ValueError(
            f"row-sharded MTTKRP needs mode {mode}'s extent ({n_rows}) "
            f"divisible by the data-axis size ({p}) — the reduce-scatter "
            f"returns equal row blocks to their owners")
    group = ctx.data_group
    buckets = st.row_buckets(mode, planner_config(block_rows).block_rows)
    cols = []
    nxt = _gather_slice(factors_local, 0, rs, group, skip=mode)
    for k in range(h):
        cur = nxt
        if k + 1 < h:
            nxt = _gather_slice(factors_local, k + 1, rs, group, skip=mode)
        part = kops.mttkrp_bucketed(buckets, [None if q is None else q.wait()
                                              for q in cur],
                                    num_rows=n_rows)
        cols.append(coll.reduce_scatter(part, group))
    out = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    return out[:, :r]
