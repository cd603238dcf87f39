"""A closed loop of one client over a pool of calls drawn in set-up: the
part the serving entries share."""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from tcbench import gen, stats


def free() -> None:
    """Release what the program's dropped state held on the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class ClosedLoop:
    """``call(k)`` answers pool call ``k`` on the host (a numpy array, or a
    tuple of them, the first checked for finiteness and counting the
    users); the window walks through the pool, and starts it again (with a
    note on standard error) only if a window outlasts it. Each call is timed from its submission to its answer;
    the first and a seed-drawn ``check_share`` of the others keep their
    answers for the reference."""
    END_TO_END = ("users_per_s", "batch_p95_ms")
    SPAN = "tcbench.call"

    def __init__(self, cell):
        self.cell = cell
        self.attempted = self.failed = self.users = 0
        self.latencies: List[float] = []
        self.order: List[int] = []          # pool index of each window call
        self.kept: List[tuple] = []         # (pool index, answer)
        self._sample = gen.host_rng(cell.seed, "sample")
        self.pool: list = []
        self.shape = tuple(cell.config["shape"])
        self.rank = int(cell.config["rank"])

    def factors(self) -> List[torch.Tensor]:
        """The served model's factors, N(0, 1/R) from the seed."""
        return gen.normal_factors(
            self.shape, self.rank,
            gen.device_generator(self.cell.seed, "factors", self.cell.device))

    def window_step(self) -> None:
        k = self.attempted % len(self.pool)
        if k == 0 and self.attempted:
            print(f"tcbench: the pool's {len(self.pool)} calls are spent; "
                  f"calls repeat from here", file=sys.stderr, flush=True)
        with self.cell.tracer.span(self.SPAN):
            t0 = time.perf_counter()
            answer = self.call(k)
            self.latencies.append(time.perf_counter() - t0)
        first = answer[0] if isinstance(answer, tuple) else answer
        if not np.isfinite(first).all():
            self.failed += 1
        if self._sample.random() < self.cell.traffic["check_share"] or \
                self.attempted == 0:
            self.kept.append((k, answer))
        self.order.append(k)
        self.attempted += 1
        self.users += len(first)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"users_per_s": self.users / window_s,
                "batch_p95_ms": stats.percentile(self.latencies, 0.95) * 1e3}
