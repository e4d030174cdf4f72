"""Exact recheck, f64 oracle: the share of the profiled window in which
no device op ran while one of the program's ``join.pip.oracle`` ranges
(``pip_join``'s f64 oracle of the recheck's tie rows) was open (see
``idle_h2d_share.py``)."""

from geobench import harness

_idle = harness.reader("idle_h2d_share.batch")


def read(trace):
    return _idle.idle_share(trace, "join.pip.oracle")
