"""The benchmark of the PyTorch and CUDA port (``port/repro_torch``).

Run from the root of a checkout::

    python3 -m tcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``tcbench/configs/<config>.json``: the deployment's sizes, its source,
  what was reduced and what was assumed;
* ``tcbench/traffic/<cell>.json``: the mix's parameters, the entry it
  drives (``tcbench/entries/<entry>.py``), the plain reference that judges
  it (``tcbench/reference/<reference>.py``) and the limit of every number
  compared;
* ``tcbench/metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick is frozen here, apart from the program that later changes
edit: the input generators (``gen``), the bytes and operations of a pass
(``roofline``), the percentile picker (``stats``), the reading of the
profiler's trace (``trace``) and the plain references. Nothing here imports
JAX, the JAX package or ``benchmarks``; the references import nothing of
the port.
"""
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
