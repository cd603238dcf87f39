"""Top-k cells: a closed loop of one client, each call ``queries_per_call``
queries to ``serve.ServeEngine.top_k`` (every mode but the target fixed).

Set-up draws the factors on the card from the seed, builds the engine,
draws a pool of distinct calls on the card from the seed, kept on the host
as a client would send them (more calls than a window sends, so none
repeats), and runs the first call, which captures the one graph the
traffic's shape uses. The window walks through the pool; a call is timed from its submission to its ids and scores on the
host. A sample of the window's calls, drawn from the seed, keeps its answers
for the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from tcbench import gen
from tcbench.loop import ClosedLoop, free
from tcbench.reference import common as C

# the program span logged once a window step: the padding of a call's
# queries
CALL_SPAN = "serve/top_k/pad"


class Entry(ClosedLoop):
    SPAN = "tcbench.top_k"

    def __init__(self, cell):
        super().__init__(cell)
        t = cell.traffic
        self.target = int(t["target_mode"])
        self.k = int(t["k"])
        self.t = t
        self.ref = cell.reference
        self._engine = None

    def setup(self) -> None:
        from repro_torch.serve import ServeEngine, ServingModel
        t, dev = self.t, self.cell.device
        popular = t["popularity"]
        weights = gen.popularity(self.shape[popular["mode"]], popular,
                                 t["layout_seed"])
        self.pool = gen.topk_pool(
            gen.device_generator(self.cell.seed, "pool", dev), self.shape,
            self.target, t["pool_calls"], t["queries_per_call"],
            popular["mode"], weights)
        model = ServingModel(self.factors(), link="identity")
        self._engine = ServeEngine(model, max_batch=t["queries_per_call"],
                                   device=dev)
        self._engine.top_k(self.pool[0], self.target, self.k)

    def call(self, k: int) -> tuple:
        """(scores, ids) of pool call ``k``, each (B, k)."""
        return self._engine.top_k(self.pool[k], self.target, self.k)

    def work(self) -> Dict:
        return {"calls": self.attempted}

    def release(self) -> None:
        self._engine = None
        free()

    def answers(self, prec: Optional[C.Precision] = None) -> List[tuple]:
        if prec is None:
            return self.kept
        fs = self.factors()
        out = []
        for k, _ in self.kept:
            v, i = self.ref.top(self.pool[k], fs, self.target, self.k, prec)
            out.append((k, (v.cpu().numpy(), i.cpu().numpy())))
        return out

    def numbers(self, got: List[tuple]) -> Dict[str, float]:
        C.no_tf32()
        fs = self.factors()
        pairs = []
        for k, answer in got:
            ref = self.ref.scores(self.pool[k], fs, self.target,
                                  C.REFERENCE)
            pairs.append(self.ref.gaps(answer, ref, self.k))
        return self.ref.numbers(pairs)
