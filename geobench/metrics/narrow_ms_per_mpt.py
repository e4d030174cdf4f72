"""Exact recheck, narrow re-join: device milliseconds a million points of
``pip_join``'s ``join.pip.narrow`` stages (the re-join of the cell band
on alternately rounded cells, timed over each call's points), from the
program's counters (see ``loop_cells_ms_per_mpt.py``)."""

from geobench import harness

_cells = harness.reader("loop_cells_ms_per_mpt.stream")


def read(trace):
    return _cells.ms_per_mpt("join.pip.narrow")
