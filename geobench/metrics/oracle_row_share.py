"""Exact recheck: the share of the points joined in the profiled window
that the f64 oracle answered, from the program's counters
``join.recheck_rows{lane="oracle"}`` over
``trace.stage_points{stage="join.pip.cells"}``
(``mosaic_tpu_torch.obs.metrics.REGISTRY``). The program fills both only
while a profiler records; nothing is returned where it has no such
counter."""

from geobench import harness

_cells = harness.reader("loop_cells_ms_per_mpt.stream")
ROWS = "join.recheck_rows"


def read(trace):
    try:
        from mosaic_tpu_torch.obs.metrics import REGISTRY
    except ImportError:
        return None
    snap = REGISTRY.snapshot()
    rows = [s["value"] for s in snap.get(ROWS, {}).get("series", [])
            if s["labels"] == {"lane": "oracle"}]
    pts = _cells.stage_value(snap, _cells.POINTS, "join.pip.cells")
    if not rows or not pts:
        return None
    return rows[0] / pts
