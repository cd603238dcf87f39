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

The program is imported inside ``setup``, so that reading a spec needs no
program."""
