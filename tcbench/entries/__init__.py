"""What a cell's window drives, one module a kind of entry, named by the
traffic file's ``entry``. Each module's ``Entry(cell)`` has

* ``END_TO_END``: the end-to-end metrics it reports (``setup_s`` apart);
* ``setup()``: inputs from the seed, the program's set-up, warm-up, and
  for the solvers the compared first sweeps;
* ``window_step()``: one unit of timed work, answered on the host;
* ``end_to_end(window_s)``, ``attempted``, ``failed``, ``work()`` (what
  the per-layer readers count with);
* ``release()``: the program's state freed;
* ``answers(prec)``: the compared answers, from the program (None) or from
  the reference put in its place at ``prec``; ``numbers(got)``: the
  numbers compared, against the float64 reference.

The module itself declares ``CALL_SPAN``: the program span logged once
a window step (the tests count it against ``attempted`` in a traced
run).

The program is imported inside ``setup``, so that reading a spec needs no
program.

A cell of ``"chips": 4`` runs its rank 0 in the harness's own process, on
``cuda:0``, so that the profiler's window, the program's spans and
counters and ``memory_peak_bytes`` are rank 0's. Its entry starts ranks 1
to 3 itself in ``setup()`` (a process each, one card each, nccl) and stops
them and their process group in ``release()``, waiting until each has
ended; on the CPU it runs the same ranks over gloo. An entry that spawned
every rank, as ``launch/complete.py`` does for ``--mesh``, would leave the
harness's process with an empty trace and a peak of zero."""
