"""CPU tests of the benchmark (``python -m pytest tcbench/tests``); the
tests marked ``cuda`` run on the card and skip here."""
