"""Host entry: the share of the profiled window in which no device op ran
while one of the program's ``join.pip.h2d`` ranges (the pageable copies
of ``pip_join``) was open: the overlap of the window's idle gaps with
those ranges, not the gap's start, over the window. Nothing is returned
where the trace holds no such range."""

STAGE = "join.pip.h2d"


def union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle_share(trace, stage: str):
    p = trace.profile
    if p is None or p.window_s <= 0:
        return None
    w0, w1 = p.window
    ranges = union((max(s, w0), min(e, w1)) for n, s, e in p.host_spans
                   if n == stage and min(e, w1) > max(s, w0))
    if not ranges:
        return None
    idle, j = 0.0, 0
    for gs, ge in p.gaps():
        while j < len(ranges) and ranges[j][1] <= gs:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < ge:
            idle += min(ge, ranges[k][1]) - max(gs, ranges[k][0])
            k += 1
    return idle / 1e6 / p.window_s


def read(trace):
    return idle_share(trace, STAGE)
