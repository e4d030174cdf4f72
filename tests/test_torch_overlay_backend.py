"""`intersects_join(backend=)`: the port's default device lane, the f64
host oracle (``"oracle"``, and ``"native"`` as the reference reads it)
and the explicit ``"device"`` give the same pairs, the reference's, on the
inputs of the reference's `tests/test_overlay_join.py`."""

from __future__ import annotations

import numpy as np
import pytest

from mosaic_tpu.core.geometry import wkt as ref_wkt
from mosaic_tpu.core.index.bng import BNGIndexSystem as RefBNG
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.runtime.errors import RetryExhausted as RefRetryExhausted
from mosaic_tpu.sql.overlay import intersects_join as ref_intersects_join
from mosaic_tpu_torch.core.geometry import wkt
from mosaic_tpu_torch.core.index import BNG, H3
from mosaic_tpu_torch.runtime import faults, telemetry
from mosaic_tpu_torch.runtime.errors import DegradedResult, RetryExhausted
from mosaic_tpu_torch.sql import intersects_join, overlay_join


def _squares(n, size, offx, offy, scale=1.0):
    out = []
    for i in range(n):
        x0 = offx + (i % 3) * scale
        y0 = offy + (i // 3) * scale
        out.append(
            f"POLYGON (({x0} {y0}, {x0 + size} {y0}, {x0 + size} {y0 + size},"
            f" {x0} {y0 + size}, {x0} {y0}))"
        )
    return out


CASES = {
    "h3": (7, _squares(6, 0.08, -0.02, 51.48, 0.06), _squares(6, 0.08, 0.01, 51.50, 0.05)),
    "bng": (4, _squares(6, 4030, 530000, 180000, 3070), _squares(6, 4030, 531517, 181533, 2531)),
    "core": (7, _squares(1, 0.5, 0.0, 51.0), _squares(1, 0.05, 0.2, 51.2)),
}


def _inputs(case):
    res, left, right = CASES[case]
    grid, ref_grid = (BNG, RefBNG()) if case == "bng" else (H3, RefH3())
    return (
        (wkt.from_wkt(left), wkt.from_wkt(right), grid, res),
        (ref_wkt.from_wkt(left), ref_wkt.from_wkt(right), ref_grid, res),
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_backend_gives_the_references_pairs(case):
    port, ref = _inputs(case)
    want = ref_intersects_join(*ref)
    assert want.shape[0] > 0
    got = {
        "default": intersects_join(*port, device="cpu"),
        "device": intersects_join(*port, backend="device", device="cpu"),
        "oracle": intersects_join(*port, backend="oracle"),
        "native": intersects_join(*port, backend="native"),
    }
    for lane, pairs in got.items():
        assert not isinstance(pairs, DegradedResult), lane
        assert pairs.dtype == want.dtype and np.array_equal(pairs, want), lane
    assert np.array_equal(overlay_join(*port, backend="oracle"), want)


def test_oracle_lane_needs_no_device():
    """The oracle lane runs on the host alone: without CUDA, a call with
    no ``device`` answers, where the device lane needs one."""
    port, _ = _inputs("core")
    assert intersects_join(*port, backend="oracle").tolist() == [[0, 0]]


@pytest.mark.parametrize("backend", ["bogus", "ORACLE", "cpu"])
def test_unknown_backend_raises(backend):
    port, _ = _inputs("core")
    with pytest.raises(ValueError, match="backend must be 'device', 'oracle' or 'native'"):
        intersects_join(*port, backend=backend, device="cpu")


def test_oracle_lane_has_no_fallback_as_in_the_reference():
    """Past the retry budget the oracle lane raises `RetryExhausted`, as
    the reference's does (there is nothing to degrade to)."""
    port, ref = _inputs("h3")
    with ref_faults.transient_errors(10, sites=("overlay.predicate",)):
        with pytest.raises(RefRetryExhausted):
            ref_intersects_join(*ref, backend="oracle")
    with telemetry.capture() as events, faults.transient_errors(
        10, sites=("overlay.predicate",)
    ):
        with pytest.raises(RetryExhausted):
            intersects_join(*port, backend="oracle")
    assert not any(e["event"] == "degraded" for e in events)
