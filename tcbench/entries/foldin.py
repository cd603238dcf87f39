"""Fold-in cells: a closed loop of one client, each call ``users`` cold
users' histories to ``serve.ServeEngine.fold_in``.

Set-up draws the factors on the card from the seed (N(0, 1/R), the
configuration's extents and rank), builds the engine, and draws a pool of
distinct calls on the card from the seed, brought to the host as a client
would send them: more calls than a window sends, so none repeats. It runs
one call of each graph key the pool uses (the fullest bucket of
``bucket_users`` users, in entries, to a power of two), so that every key
has its CUDA graph before the window. The window walks through the pool; a
call is timed from its submission to its rows on the host. A sample of the
window's calls, drawn from the seed, keeps its rows for the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tcbench import gen
from tcbench.loop import ClosedLoop, free
from tcbench.reference import common as C

# the program span logged once a window step: the packing of a call's
# histories
CALL_SPAN = "serve/fold_in/pack"


class Entry(ClosedLoop):
    SPAN = "tcbench.fold_in"

    def __init__(self, cell):
        super().__init__(cell)
        c, t = cell.config, cell.traffic
        self.lam = float(c["foldin_lam"])
        self.mode = int(t["mode"])
        self.t = t
        self.ref = cell.reference
        self._engine = None
        self._want: Dict[int, torch.Tensor] = {}

    def setup(self) -> None:
        from repro_torch.serve import ServeEngine, ServingModel
        t, dev = self.t, self.cell.device
        law, popular = t["history_lengths"], t["popularity"]
        top = dict(law, max=min(law["max"], self.shape[popular["mode"]]))
        lengths = np.rint(gen.lognormal_quantiles(t["users_per_call"], top)
                          ).astype(np.int64)
        weights = gen.popularity(self.shape[popular["mode"]], popular,
                                 t["layout_seed"])
        self.pool = gen.foldin_pool(
            gen.device_generator(self.cell.seed, "pool", dev), self.shape,
            self.mode, t["pool_calls"], lengths, popular["mode"], weights,
            tuple(t["ratings"]), t["layout_seed"])
        model = ServingModel(self.factors(), link="identity")
        self._engine = ServeEngine(model, max_batch=t["users_per_call"],
                                   foldin_lam=self.lam, device=dev)
        keys = {}
        for k, call in enumerate(self.pool):
            keys.setdefault(gen.bucket_capacity(np.diff(call.offsets),
                                                t["bucket_users"]), k)
        for k in sorted(keys.values()):
            self._engine.fold_in(self.pool[k].histories, self.mode)

    def call(self, k: int) -> np.ndarray:
        return self._engine.fold_in(self.pool[k].histories, self.mode)

    def work(self) -> Dict:
        return {"calls": self.attempted, "rank": self.rank,
                "nd": len(self.shape),
                "call_shapes": [(self.pool[k].nnz, self.pool[k].distinct,
                                 len(self.pool[k].histories))
                                for k in self.order]}

    def release(self) -> None:
        self._engine = None
        free()

    def answers(self, prec: Optional[C.Precision] = None) -> List[tuple]:
        """(pool index, rows) of every kept call: the program's, or the
        reference's at ``prec`` in its place."""
        if prec is None:
            return self.kept
        fs = self.factors()
        done: Dict[int, torch.Tensor] = {}
        for k, _ in self.kept:
            if k not in done:
                done[k] = self.ref.solve(self.pool[k], fs, self.mode,
                                         self.lam, prec).cpu()
        return [(k, done[k]) for k, _ in self.kept]

    def numbers(self, got: List[tuple]) -> Dict[str, float]:
        if not self._want:
            C.no_tf32()
            self._want = dict(self.answers(C.REFERENCE))
        return self.ref.numbers([torch.as_tensor(rows) for _, rows in got],
                                [self._want[k] for k, _ in got])
