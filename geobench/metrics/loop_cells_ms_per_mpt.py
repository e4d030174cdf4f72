"""Cell assignment inside the stream loop: device milliseconds a million
points of the loop's own ``stream.assign`` stages (the prefetch assigns
included), from the program's counters ``trace.stage_device_seconds``
and ``trace.stage_points`` of that stage
(``mosaic_tpu_torch.obs.metrics.REGISTRY``). The program fills them only
while a profiler records, that is over the profiled window of a traced
run; nothing is returned where it has no such counter."""

DEVICE_S = "trace.stage_device_seconds"
POINTS = "trace.stage_points"


def stage_value(snap: dict, metric: str, stage: str):
    for s in snap.get(metric, {}).get("series", []):
        if s["labels"] == {"stage": stage}:
            return s["value"]
    return None


def ms_per_mpt(stage: str):
    try:
        from mosaic_tpu_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    snap = REGISTRY.snapshot()
    sec, pts = stage_value(snap, DEVICE_S, stage), stage_value(snap, POINTS, stage)
    if sec is None or not pts:
        return None
    return sec * 1e3 / (pts / 1e6)


def read(trace):
    return ms_per_mpt("stream.assign")
