"""Host entry: the 90th percentile of the host-clock time of every join
call in the window, ended by its numpy answer (the ``batch.call`` spans).
It is the highest percentile with ten calls beyond it where the window
holds 100 calls or more; below that the reader returns nothing."""

import math


def read(trace):
    calls = sorted(s["seconds"] for s in trace.of("batch.call", "host"))
    rank = math.ceil(0.9 * len(calls))
    if len(calls) - rank < 10:
        return None
    return calls[rank - 1] * 1e3
