"""Planner tunables recorded in plan cache keys.

A :class:`PlannerConfig` carries the static knobs that change what a plan
*executes* (not what it computes): the CCSR bucket granularity of the
bucketed/fused kernels and the H-slicing factor of the row-sharded
distributed paths. Configs are frozen/hashable and participate in the plan
cache key, so two calls that differ only in bucket granularity get distinct
plans (and distinct ingest-time bucket views).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Static execution knobs for planner dispatch.

    ``block_rows``  — rows per CCSR bucket consumed by the bucketed MTTKRP
                      and fused CG-matvec kernels (one-hot matmul height);
    ``h_slices``    — column-slice count for the row-sharded distributed
                      paths (paper Fig. 2 per-slice gather schedule).
    """
    block_rows: int = 8
    h_slices: int = 1

    def with_h_slices(self, h: int) -> "PlannerConfig":
        return self if h == self.h_slices else \
            dataclasses.replace(self, h_slices=h)


DEFAULT_CONFIG = PlannerConfig()

# process-wide default, resolved at call time (not import time) so the
# launch scripts can retune it — e.g. ``launch/complete.py --block-rows`` —
# and ingest (data.pipeline) and dispatch agree on the bucket granularity
_DEFAULT = DEFAULT_CONFIG


def default_config() -> PlannerConfig:
    return _DEFAULT


def set_default_config(cfg: PlannerConfig) -> None:
    global _DEFAULT
    _DEFAULT = cfg
