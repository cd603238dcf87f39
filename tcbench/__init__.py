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

A new cell joins through new files and new entries in ``BENCHMARK.json``
alone, and edits no file that is already here: its traffic file, which
also gives under ``small`` the ``config`` and ``traffic`` keys that the
CPU tests replace to run it at a small size (the run never reads
``small``); its configuration, if it is a new one; and, for a new kind of
work, an entry that declares ``END_TO_END`` and ``CALL_SPAN``
(``tcbench/entries/__init__.py`` says what an entry owes, a four-chip one
included) with its plain reference. The tests find every cell in
``BENCHMARK.json`` and pick each cell's per-entry checks by its entry;
a new entry brings the tests of its own faults in new files.

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
