"""Checkpoints with atomic commit and asynchronous save, in the JAX
package's on-disk format, so each package restores the other's.

Format: a step directory ``step_<n:09d>/`` holding one ``.npy`` per leaf of
the state plus ``manifest.json`` (``step``, user ``metadata``, and each
leaf's shape and dtype under ``leaves``). Writes go to ``step_<n>.tmp``
and are committed by an atomic rename: a crash in the middle of a save
never corrupts the newest committed step.

A state is a tensor (or numpy array) or any nest of lists, tuples, named
tuples (``GGNState``, ``AdamState``) and dicts of them; ``None`` entries
hold no leaf. A leaf's file name is its path in the nest, written as the
JAX package writes it: each entry's key (``[i]`` for a list or tuple
position, ``['k']`` for a dict key, ``.name`` for a named-tuple field),
joined by ``/``, every character outside ``[A-Za-z0-9_.-]`` replaced by
``_``; dict keys are visited in sorted order.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _entries(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf of ``tree``, in the JAX package's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _entries(tree[k], path + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _entries(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _entries(x, path + (f"[{i}]",))
    else:
        yield path, tree


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken in turn from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(getattr(like, n), leaves)
                            for n in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _entries(tree)]


def tree_map(fn: Callable, tree):
    return _rebuild(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def tree_map_with_path(fn: Callable, tree):
    """``fn(key, leaf)`` of every leaf, ``key`` the leaf's checkpoint name."""
    return _rebuild(tree, iter([fn(key, leaf)
                                for key, leaf in _leaf_paths(tree).items()]))


def _leaf_paths(tree) -> Dict[str, Any]:
    out = {}
    for path, leaf in _entries(tree):
        key = "/".join(path) or "root"
        out[re.sub(r"[^A-Za-z0-9_.\-]", "_", key)] = leaf
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf) -> np.ndarray:
    """A host copy that shares no memory with ``leaf`` (``.cpu()`` of a CPU
    tensor is the tensor itself)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(directory: str, step: int, state, metadata: Optional[dict] = None,
         keep_last: int = 3) -> str:
    """Atomic checkpoint save; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _leaf_paths(state).items():
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int):
    steps = sorted(_list_steps(directory))
    # keep_last=0 keeps nothing: steps[:-0] would be the empty slice
    doomed = steps[:-keep_last] if keep_last > 0 else steps
    for s in doomed:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def _list_steps(directory: str) -> List[int]:
    """Committed steps: ``step_<n>`` directories with a manifest (a ``.tmp``
    left by a crash does not count)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The committed manifest of one step: the leaf keys with their shape
    and dtype, and the user metadata."""
    path = os.path.join(directory, f"step_{step:09d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


def _numpy_dtype(like_leaf) -> Optional[np.dtype]:
    dtype = getattr(like_leaf, "dtype", None)
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _validate_leaf(path: str, key: str, arr: np.ndarray, entry: dict,
                   like_leaf) -> None:
    """Fail naming the leaf: the array on disk must match the manifest's
    record (corruption, partial write), and the record must match the
    restore target (structure drift, e.g. the rank changed)."""
    m_shape = tuple(entry["shape"])
    if tuple(arr.shape) != m_shape or str(arr.dtype) != entry["dtype"]:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} on disk is "
            f"{tuple(arr.shape)}/{arr.dtype} but the manifest records "
            f"{m_shape}/{entry['dtype']} — corrupted or partially written")
    like_shape = tuple(np.shape(like_leaf))
    if like_shape != m_shape:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has shape {m_shape} but the "
            f"restore target expects {like_shape} — checkpoint/structure "
            f"drift (e.g. rank changed between fit and serve)")
    like_dtype = _numpy_dtype(like_leaf)
    if like_dtype is not None and like_dtype != arr.dtype:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has dtype {arr.dtype} but the "
            f"restore target expects {like_dtype}")


def _place(arr: np.ndarray, like_leaf):
    """A tensor leaf comes back as a tensor on ``like_leaf``'s device."""
    if isinstance(like_leaf, torch.Tensor):
        return torch.from_numpy(arr).to(like_leaf.device)
    return arr


def restore(directory: str, step: int, like,
            shard_fn: Optional[Callable[[str, np.ndarray], Any]] = None):
    """Restore one step into the structure of ``like``; returns ``(state,
    manifest)``. Every leaf is checked against the manifest's shape and
    dtype, and lands on the device of ``like``'s leaf.

    ``shard_fn(key, arr)`` cuts each logical leaf to this rank's block
    (the elastic restore: ``like`` then holds the blocks); the block is
    what is checked against ``like``. Without it the logical leaf is."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaf_paths(like)
    recorded = manifest.get("leaves", {})
    missing = sorted(set(leaves) - set(recorded))
    if missing:
        raise ValueError(
            f"checkpoint {path}: leaves {missing} absent from the manifest "
            f"(it records {sorted(recorded)}) — structure drift")
    out = []
    for key, like_leaf in leaves.items():
        arr = np.load(os.path.join(path, key + ".npy"))
        _validate_leaf(path, key, arr, recorded[key],
                       like_leaf if shard_fn is None else arr)
        if shard_fn is not None:
            arr = np.ascontiguousarray(shard_fn(key, arr))
            _validate_leaf(path, key, arr, {"shape": list(arr.shape),
                                            "dtype": str(arr.dtype)},
                           like_leaf)
        out.append(_place(arr, like_leaf))
    return _rebuild(like, iter(out)), manifest


class Checkpointer:
    """Asynchronous checkpointer: ``save_async`` copies the state to the
    host and returns, the write runs on a background thread, ``wait()``
    joins it.

    A failed background write is not swallowed: its exception is re-raised,
    naming the step, at the next ``wait()`` or ``save_async()``."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None

    def save_async(self, step: int, state, metadata: Optional[dict] = None):
        self.wait()
        # host copies first, so the caller may go on changing its tensors
        host_state = tree_map(_host_copy, state)
        # and a copy of the metadata, which callers pass live (a growing
        # metric history): the manifest records this step's
        if metadata is not None:
            metadata = json.loads(json.dumps(metadata))

        def work():
            try:
                save(self.directory, step, host_state, metadata,
                     self.keep_last)
            except BaseException as e:   # re-raised on the caller's thread
                self._error = e
                self._error_step = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, step = self._error, self._error_step
            self._error = self._error_step = None
            raise RuntimeError(
                f"async checkpoint save of step {step} failed; the newest "
                f"on-disk checkpoint is stale") from err

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, like):
        step = self.latest()
        if step is None:
            return None
        state, manifest = restore(self.directory, step, like)
        return step, state, manifest
