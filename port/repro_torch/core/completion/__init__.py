"""Completion solvers; this slice ports implicit-CG ALS (paper §2.2)."""
from repro_torch.core.completion.als import (als_sweep, als_sweep_explicit,
                                             als_update_mode,
                                             als_update_mode_explicit,
                                             batched_cg, batched_pcg,
                                             gram_matvec)

__all__ = ["als_sweep", "als_sweep_explicit", "als_update_mode",
           "als_update_mode_explicit", "batched_cg", "batched_pcg",
           "gram_matvec"]
