"""Sparse tensor container, TTTP and the LOCAL execution context."""
