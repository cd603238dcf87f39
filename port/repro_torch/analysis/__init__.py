"""The port's static gates: its lint, the planner contract sweep, cache-key
aliasing and pytree registrations, and an import-graph dead-code report,
behind one CLI (``python -m repro_torch.analysis``); the SPMD passes are
``repro_torch.analysis.spmd``. The counterpart of the JAX package's
``repro.analysis``, with its rule ids, suppression syntax and exit codes.

The passes are imported lazily by the CLI: importing this package stays
cheap (it is a dead-code root and an entry point).
"""
from repro_torch.analysis.cli import main

__all__ = ["main"]
