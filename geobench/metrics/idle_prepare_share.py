"""Host entry: the share of the profiled window in which no device op ran
while one of the program's ``join.pip.prepare`` ranges (``pip_join``'s
numpy shift and cast) was open (see ``idle_h2d_share.py``)."""

from geobench import harness

_idle = harness.reader("idle_h2d_share.batch")


def read(trace):
    return _idle.idle_share(trace, "join.pip.prepare")
