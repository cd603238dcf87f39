"""The least time the chip needs for the logical work of a pass over the
nonzeros, frozen for the benchmark.

Counted from shapes, not from the program's layout: the valid entries (a
value and N int32 indices each), the distinct factor rows a pass reads,
and what it writes, each byte once. Padded slots, local row numbers and
re-reads are the program's business, so a change that trims them moves
the measured time and not the bound. The peaks are the H100 SXM data
sheet's (NVIDIA; dense, no sparsity, at the 700 W power limit) and cannot
be overridden. (The program's own ``launch/roofline.py`` and
``obs/profile.py`` count the padded layout and read overrides from the
environment; this is written anew, not copied.)
"""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = 4
I32 = 4


def entry_bytes(m: int, nd: int) -> int:
    """A value and ``nd`` int32 indices for each of ``m`` entries."""
    return m * (F32 + nd * I32)


def pass_bytes(kind: str, m: int, nd: int, rank: int, rows_read: int,
               rows_out: int) -> int:
    """Bytes of one pass: TTTP reads the entries and ``rows_read`` factor
    rows and writes one value an entry; the MTTKRP reads the same and
    writes ``rows_out`` rows; the Gram matvec also reads x's
    ``rows_out`` rows and writes y's."""
    read = entry_bytes(m, nd) + rows_read * rank * F32
    if kind == "tttp":
        return read + m * F32
    if kind == "mttkrp":
        return read + rows_out * rank * F32
    if kind == "cg_matvec":
        return read + 2 * rows_out * rank * F32
    raise ValueError(f"unknown kernel kind {kind!r}")


def pass_flops(kind: str, m: int, nd: int, rank: int) -> int:
    """Operations of one pass: N-1 products and a sum an entry and column
    (TTTP, MTTKRP); the matvec's Khatri-Rao row, its dot with x and the
    scaled add into y."""
    if kind in ("tttp", "mttkrp"):
        return m * rank * nd
    if kind == "cg_matvec":
        return m * rank * (nd + 2)
    raise ValueError(f"unknown kernel kind {kind!r}")


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def pass_bound_s(kind: str, m: int, nd: int, rank: int, rows_read: int,
                 rows_out: int) -> float:
    return bound_s(pass_bytes(kind, m, nd, rank, rows_read, rows_out),
                   pass_flops(kind, m, nd, rank))


def sweep_bound_s(passes: Sequence[Sequence], m: int, rank: int,
                  rows: Sequence[int]) -> float:
    """The least time of one sweep: the sum of its passes' bounds.
    ``passes`` are the traffic file's ``[kind, mode, count]`` (mode
    ``None`` for a TTTP, which reads every mode's rows); ``rows[d]`` is the
    number of distinct rows mode d's indices touch."""
    nd = len(rows)
    total = 0.0
    for kind, mode, count in passes:
        if mode is None:
            read, out = sum(rows), 0
        else:
            read, out = sum(rows) - rows[mode], rows[mode]
        total += count * pass_bound_s(kind, m, nd, rank, read, out)
    return total
