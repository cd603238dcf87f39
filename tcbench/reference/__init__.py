"""Plain references that decide ``correct``: straightforward PyTorch over
the coordinate lists the benchmark made, in float64. They import nothing of
the program and take nothing it made; each follows the algorithm the
program states, written out again from its description. The same code in a
lower precision (:data:`common.CONTROL`) is the control that a limit has to
fail."""
