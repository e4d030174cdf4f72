"""Probe: device milliseconds a million points, from CUDA events around the
stream's ``join`` of each ring slot with its cells (``stream.join``)."""


def read(trace):
    spans = trace.of("stream.join", "device")
    pts = sum(s["points"] for s in spans)
    return sum(s["seconds"] for s in spans) * 1e3 / (pts / 1e6) if pts else None
