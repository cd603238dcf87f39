"""The port's collectives: one thin wrapper over ``torch.distributed``.

Every collective of the distributed algorithms goes through here, so each
is counted: calls per op (``all_reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``p2p``) and the payload bytes each call
hands to the backend (``bytes``), in plain integers (:func:`counts`,
:func:`reset_counts`, as ``kernels.ops`` counts launches) and, with ``obs``
on, under the counters ``dist/<op>`` and ``dist/bytes``.

The backend is the process group's; nothing here chooses or switches it.
Gloo reduces in host memory, so under a gloo group a CUDA tensor is copied
to the host, the op runs on the copy and the result is copied back to the
device: explicitly, and counted under ``host_staged_bytes``
(``dist/host_staged_bytes``, both directions). Under nccl device tensors
go as they are, and a CPU tensor is refused by nccl itself.

``all_gather`` and ``reduce_scatter`` call ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, names that torch 2.11 and 2.13 both have (2.13
marks them deprecated; the notice is silenced here, nothing else).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs

OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "p2p")
_COUNTS: Dict[str, int] = {}


def reset_counts() -> None:
    _COUNTS.clear()
    _COUNTS.update({op: 0 for op in OPS})
    _COUNTS.update(bytes=0, host_staged_bytes=0)


reset_counts()


def counts() -> Dict[str, int]:
    """Calls per op and bytes since the last :func:`reset_counts`."""
    return dict(_COUNTS)


def _add(name: str, n: int) -> None:
    _COUNTS[name] += n
    obs.counter_add(f"dist/{name}", n)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """(buffer the backend works on, whether it is a host copy). The buffer
    is always a new tensor: the ops reduce in place."""
    if _staged(t, group):
        _add("host_staged_bytes", t.numel() * t.element_size())
        return t.detach().to("cpu", copy=True).contiguous(), True
    return t.detach().contiguous().clone(), False


def _back(buf: torch.Tensor, like: torch.Tensor, staged: bool
          ) -> torch.Tensor:
    if not staged:
        return buf
    _add("host_staged_bytes", buf.numel() * buf.element_size())
    return buf.to(like.device)


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The ``op`` (sum, max or min) of ``x`` over ``group``, as a new tensor
    on ``x``'s device (``x`` is left as it was)."""
    _add("all_reduce", 1)
    _add("bytes", x.numel() * x.element_size())
    buf, staged = _to_host(x, group)
    dist.all_reduce(buf, op=_reduce_op(op), group=group)
    return _back(buf, x, staged)


def all_reduce_ints(values: Sequence[int], group=None,
                    op: str = "sum") -> List[int]:
    """:func:`all_reduce` of host ints (through the card under nccl, which
    takes no host tensor)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor(list(values), dtype=torch.int64, device=dev)
    # host ints by contract (a restart's agreed step), never in a sweep
    # repro-lint: disable=JS002 -- the result is host ints by contract
    return [int(v) for v in all_reduce(t, group, op).tolist()]


class Pending:
    """An all-gather in flight: :meth:`wait` returns its result on the
    input's device."""

    def __init__(self, work, buf: torch.Tensor, like: torch.Tensor,
                 staged: bool):
        self._work, self._buf, self._like, self._staged = \
            work, buf, like, staged

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return _back(self._buf, self._like, self._staged)


def all_gather(x: torch.Tensor, group=None, async_op: bool = False):
    """The blocks ``x`` of every rank of ``group`` stacked along dim 0 in
    group-rank order (``jax.lax.all_gather(tiled=True)``). With
    ``async_op`` a :class:`Pending` whose ``wait()`` gives the result."""
    _add("all_gather", 1)
    _add("bytes", x.numel() * x.element_size())
    src, staged = _to_host(x, group)
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        work = dist.all_gather_into_tensor(out, src, group=group,
                                           async_op=async_op)
    if async_op:
        return Pending(work, out, x, staged)
    return _back(out, x, staged)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` (P·n, ...) over ``group`` and keep this rank's block of n
    along dim 0 (``jax.lax.psum_scatter(tiled=True)``)."""
    p = dist.get_world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not a "
                         f"multiple of the group size ({p})")
    _add("reduce_scatter", 1)
    _add("bytes", x.numel() * x.element_size())
    src, staged = _to_host(x, group)
    out = src.new_empty((src.shape[0] // p,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return _back(out, x, staged)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (a new
    tensor; the other ranks' ``x`` gives the shape and dtype)."""
    _add("broadcast", 1)
    _add("bytes", x.numel() * x.element_size())
    buf, staged = _to_host(x, group)
    root = src if group is None else dist.get_global_rank(group, src)
    dist.broadcast(buf, src=root, group=group)
    return _back(buf, x, staged)


def exchange(sends: Sequence[torch.Tensor], peer: int, group=None
             ) -> List[torch.Tensor]:
    """Send each of ``sends`` to group rank ``peer`` and receive the peer's
    tensors of the same shapes and dtypes, as one ``batch_isend_irecv``
    (a ``ppermute`` between two ranks). Returns the received tensors on
    the senders' devices."""
    _add("p2p", 1)
    _add("bytes", sum(t.numel() * t.element_size() for t in sends))
    glob = peer if group is None else dist.get_global_rank(group, peer)
    ops, bufs = [], []
    for t in sends:
        buf, staged = _to_host(t, group)
        recv = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, glob, group))
        ops.append(dist.P2POp(dist.irecv, recv, glob, group))
        bufs.append((recv, t, staged))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_back(recv, t, staged) for recv, t, staged in bufs]


def barrier(group=None) -> None:
    """``dist.barrier`` (not counted: it moves no payload); under nccl on
    the rank's current card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
