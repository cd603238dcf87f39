"""The port's SPMD passes: the sharding interpreter over every planner
path (:mod:`~repro_torch.analysis.spmd.sharding`, SP001–SP004), the
collective-matching lint of its ``torch.distributed`` code
(:mod:`~repro_torch.analysis.spmd.collectives`, SP101–SP103) and the
shared-memory and register certificate of the tile lattices
(:mod:`~repro_torch.analysis.spmd.footprint`, SP201).

CLI: ``python -m repro_torch.analysis.spmd``.
"""
from repro_torch.analysis.spmd.cli import main

__all__ = ["main"]
