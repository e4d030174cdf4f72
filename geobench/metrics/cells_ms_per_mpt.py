"""Cell assignment: device milliseconds a million points, from CUDA events
around the stream's ``assign`` on each ring slot (``stream.assign``)."""


def read(trace):
    spans = trace.of("stream.assign", "device")
    pts = sum(s["points"] for s in spans)
    return sum(s["seconds"] for s in spans) * 1e3 / (pts / 1e6) if pts else None
