"""Completion solvers: implicit-CG ALS (paper §2.2), CCD++ (§2.3), SGD
(§2.4), first-order GCP and generalized Gauss-Newton for any loss."""
from repro_torch.core.completion.als import (als_sweep, als_sweep_explicit,
                                             batched_cg, batched_pcg)
from repro_torch.core.completion.ccd import ccd_sweep, ccd_sweep_tttp
from repro_torch.core.completion.gauss_newton import (GGNState, ggn_init,
                                                      ggn_sweep)
from repro_torch.core.completion.gcp import gcp_adam_init, gcp_step
from repro_torch.core.completion.sgd import sgd_sweep

__all__ = ["als_sweep", "als_sweep_explicit", "batched_cg", "batched_pcg",
           "ccd_sweep", "ccd_sweep_tttp", "sgd_sweep", "gcp_step",
           "gcp_adam_init", "GGNState", "ggn_init", "ggn_sweep"]
