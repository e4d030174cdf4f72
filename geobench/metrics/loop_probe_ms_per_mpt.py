"""Probe inside the stream loop: device milliseconds a million points of
the loop's own ``stream.join`` stages, from the program's counters (see
``loop_cells_ms_per_mpt.py``)."""

from geobench import harness

_cells = harness.reader("loop_cells_ms_per_mpt.stream")


def read(trace):
    return _cells.ms_per_mpt("stream.join")
