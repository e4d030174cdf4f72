"""Device: the share of the profiled window in which no kernel, copy or
memset ran on the card (1 - the union of their intervals / the window)."""


def read(trace):
    p = trace.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 1.0 - p.busy_s() / p.window_s
