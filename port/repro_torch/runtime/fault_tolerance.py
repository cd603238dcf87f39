"""Fault tolerance: a restartable loop and a straggler watchdog.

``RestartableLoop`` drives a step function with periodic asynchronous
checkpoints, resumes from the newest committed step (falling back to older
ones when the newest is unreadable) and takes an injected failure for
tests. ``StepWatchdog`` flags steps slower than a multiple of the median.

Over a rank layout (``layout=``) a checkpoint stays the reference's
layout-independent logical format: the leaves' blocks are gathered
(``spec_fn`` gives each leaf's spec), rank 0 alone writes, synchronously,
and every rank waits at a barrier; on resume every rank reads the same
step and cuts its blocks out of the logical leaves, and the ranks check
that they resume from one step.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.checkpoint.checkpointer import (Checkpointer, _list_steps,
                                                 restore, save,
                                                 tree_map_with_path)

log = logging.getLogger(__name__)


class StepWatchdog:
    """Flags steps slower than ``threshold × median`` (straggler signal);
    records them in ``events``."""

    def __init__(self, threshold: float = 3.0, warmup: int = 5):
        self.threshold = threshold
        self.warmup = warmup
        self.times = []
        self.events = []

    def observe(self, seconds: float, step: int):
        self.times.append(seconds)
        if len(self.times) > self.warmup:
            hist = sorted(self.times[:-1])
            med = hist[len(hist) // 2]
            if seconds > self.threshold * med:
                self.events.append((step, seconds, med))
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, seconds, med)


class RestartableLoop:
    """Checkpoint/restart driver.

    ``step_fn(step, state) -> state``; ``state`` is a tensor or a nest of
    lists, tuples, named tuples and dicts of them. Each step runs inside an
    ``obs`` span ``loop/step`` and ends with a synchronisation of the
    state's devices. The loop checkpoints asynchronously every
    ``ckpt_every`` steps and once at the end. ``fail_at`` raises after that
    step has run (and any checkpoint of it is committed), for tests of
    resume equivalence.

    ``layout`` (a ``core.distributed.DistLayout``) and ``spec_fn(key,
    leaf)`` (the leaf's spec: ``None``, ``"data"`` or ``"model"`` per dim)
    checkpoint a state sharded over ranks (see the module docstring)."""

    def __init__(self, directory: str, step_fn: Callable[[int, Any], Any],
                 ckpt_every: int = 10, keep_last: int = 3,
                 watchdog: Optional[StepWatchdog] = None,
                 metadata_fn: Optional[Callable[[int], dict]] = None,
                 layout=None, spec_fn: Optional[Callable] = None):
        self.ckpt = Checkpointer(directory, keep_last)
        self.layout = layout
        self.spec_fn = spec_fn or (lambda key, leaf: ())
        self.step_fn = step_fn
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or StepWatchdog()
        # metadata_fn(step) -> JSON-able dict stored in the manifest (the
        # experiment harness's per-sweep metric history); on resume the
        # newest manifest's metadata lands in last_metadata before the
        # first step runs, so callers can rebuild their history
        self.metadata_fn = metadata_fn
        self.last_metadata: dict = {}

    def _shard_fn(self, init_state):
        if self.layout is None:
            return None
        specs = {}
        tree_map_with_path(
            lambda key, leaf: specs.__setitem__(key, self.spec_fn(key, leaf)),
            init_state)
        import torch
        return lambda key, arr: self.layout.slice(torch.from_numpy(arr),
                                                  specs[key]).numpy()

    def _resume(self, init_state):
        start, state = self._resume_local(init_state)
        if self.layout is not None:
            from repro_torch.core import collectives as coll
            # every rank of the run must resume from one step
            # repro-lint: disable=SP103 -- all ranks agree on the step
            lo, neg_hi = coll.all_reduce_ints([start, -start], op="min")
            if lo != -neg_hi:
                raise RuntimeError(
                    f"ranks would resume from different steps ({lo} to "
                    f"{-neg_hi}): the checkpoint directory differs between "
                    f"them")
        return start, state

    def _resume_local(self, init_state):
        """Newest-first restore, falling back past unreadable steps."""
        shard_fn = self._shard_fn(init_state)
        for s in sorted(_list_steps(self.ckpt.directory), reverse=True):
            try:
                state, manifest = restore(self.ckpt.directory, s, init_state,
                                          shard_fn)
            except (OSError, EOFError, ValueError, KeyError) as e:
                log.warning("checkpoint step %d unreadable (%s); falling "
                            "back", s, e)
                continue
            log.info("resumed from step %d", s)
            self.last_metadata = manifest.get("metadata", {}) or {}
            return s + 1, state
        return 0, init_state

    def run(self, init_state, num_steps: int, fail_at: Optional[int] = None):
        start, state = self._resume(init_state)
        for step in range(start, num_steps):
            t0 = time.perf_counter()
            with obs.span("loop/step", step=step):
                state = self.step_fn(step, state)
                obs.synchronize(state)
            self.watchdog.observe(time.perf_counter() - t0, step)
            if (step + 1) % self.ckpt_every == 0:
                self._save(step, state, asynchronous=True)
            if fail_at is not None and step == fail_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
        self.ckpt.wait()
        final = num_steps - 1
        if final >= 0 and start <= final:
            # no final save when the resume point was past the end: no step
            # ran, and a save would overwrite the stored metadata with this
            # process's (empty) view
            self._save(final, state, asynchronous=False)
        return state

    def _save(self, step: int, state, asynchronous: bool) -> None:
        if self.layout is None:
            if asynchronous:
                self.ckpt.save_async(step, state, self._metadata(step))
            else:
                save(self.ckpt.directory, step, state,
                     metadata=self._metadata(step))
            return
        # every rank gathers (a collective); rank 0 writes; all wait
        full = tree_map_with_path(
            lambda key, leaf: self.layout.gather(leaf, self.spec_fn(key,
                                                                    leaf)),
            state)
        if self.layout.rank == 0:
            save(self.ckpt.directory, step, full,
                 metadata=self._metadata(step),
                 keep_last=self.ckpt.keep_last)
        self.layout.barrier()

    def _metadata(self, step: int) -> Optional[dict]:
        return None if self.metadata_fn is None else self.metadata_fn(step)
