"""Stage timing on the card: the device-timed stages of `pip_join` and of
the H3 stream loop carry CUDA-event times, read at the sync each path
makes anyway, and add no host sync.

Every test here is marked ``gpu`` and skips without CUDA. The file
imports neither JAX nor the JAX package; run it on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_stage_trace_gpu.py``
(the suite's conftest imports JAX)."""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.obs import trace
from mosaic_tpu_torch.runtime import telemetry

pytestmark = pytest.mark.gpu

BBOX = (-74.0, 40.7, -73.9, 40.786)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events have no CPU mode")
    trace.stage_timing(False)
    yield torch.device("cuda")
    trace.stage_timing(False)
    torch.cuda.set_sync_debug_mode("default")


@pytest.fixture
def h3_index(cuda):
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql.join import build_chip_index

    h3 = H3IndexSystem()
    zones = synthetic_zones(3, 3, bbox=BBOX, verts=128)
    ix = build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False),
                          edge_cap=8, device=cuda)
    return h3, ix


def _spans(events, name):
    return [e for e in events if e["event"] == "span" and e["name"] == name]


def _sync_warnings(fn):
    """``fn()``'s result and the synchronizing CUDA calls torch's sync
    debug mode reports while it runs (not its once-a-process notice that
    the mode is a prototype)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in seen)


def test_h3_stream_loop_with_stage_timing_makes_no_host_sync(h3_index, cuda):
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    h3, ix = h3_index
    rng = np.random.default_rng(29)
    ring = ring_from_host([rng.uniform(BBOX[:2], BBOX[2:], (20_000, 2)) for _ in range(3)],
                          device=cuda)
    sj = StreamJoin(ix, h3, 9, probe="adaptive")
    want = sj.run(ring, 5)
    torch.cuda.synchronize()
    trace.stage_timing(True)
    with telemetry.capture() as events:
        with trace.span("stream.run"), trace.device_stages():
            torch.cuda.set_sync_debug_mode("error")
            try:
                acc, _ = sj._loop(ring, ix, 5, False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            acc.cpu()
        got = sj.run(ring, 5)
    assert (got.checksum, got.matches, got.overflow) == (
        want.checksum, want.matches, want.overflow)
    for name, n in (("stream.assign", 2 * 6), ("stream.join", 2 * 5)):
        spans = _spans(events, name)
        assert len(spans) == n
        assert all(s["device_s"] > 0 and s["points"] == 20_000 for s in spans)
    assert len(_spans(events, "stream.fold_pull")) == 1


def test_pip_join_with_stage_timing_adds_no_sync(h3_index, cuda):
    from mosaic_tpu_torch.sql.join import pip_join

    h3, ix = h3_index
    pts = np.random.default_rng(31).uniform(BBOX[:2], BBOX[2:], (200_000, 2))

    def call():
        return pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive", device=cuda)

    want = call()
    off, syncs_off = _sync_warnings(call)
    trace.stage_timing(True)
    with telemetry.capture() as events:
        on, syncs_on = _sync_warnings(call)
    np.testing.assert_array_equal(off, want)
    np.testing.assert_array_equal(on, want)
    assert syncs_on == syncs_off
    (root,) = _spans(events, "join.pip")
    for name in ("join.pip.cells", "join.pip.probe"):
        (s,) = _spans(events, name)
        assert s["parent_id"] == root["span_id"]
        assert 0 < s["device_s"] < root["seconds"] and s["points"] == 200_000
    assert len(_spans(events, "join.pip.h2d")) == 1
    (s,) = _spans(events, "join.pip.prepare")
    assert 0 < s["device_s"] < root["seconds"] and s["points"] == 200_000


def test_pip_join_copies_once_and_equals_the_cpu(h3_index, cuda):
    """The f64 points cross once: `pip_join` makes no synchronizing CUDA
    call beyond the f64 upload, the counts' read-back and the answer's
    copy back (a pageable f32 upload of the shifted points, which the card
    now computes, would add one); and its answer on the card equals the
    CPU's on the same partition, at NYC magnitudes, on a grid whose f32
    cells both devices compute alike."""
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql.join import _probe_counts, build_chip_index, pip_join

    h3, ix = h3_index
    pts = np.random.default_rng(37).uniform(BBOX[:2], BBOX[2:], (200_000, 2))
    want = pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive", device=cuda)
    got, syncs = _sync_warnings(
        lambda: pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive", device=cuda))
    np.testing.assert_array_equal(got, want)
    on_card = torch.from_numpy(pts).to(cuda)
    cells = torch.zeros(len(pts), dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    _, upload = _sync_warnings(lambda: torch.from_numpy(pts).to(cuda))
    _, f32_upload = _sync_warnings(lambda: torch.from_numpy(pts.astype(np.float32)).to(cuda))
    _, counts = _sync_warnings(lambda: _probe_counts(cells, ix).tolist())
    _, answer = _sync_warnings(lambda: on_card[:, 0].to(torch.int32).cpu().numpy())
    assert f32_upload >= 1
    assert syncs <= upload + counts + answer

    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    table = tessellate(synthetic_zones(3, 3, bbox=BBOX, verts=128), grid, 9,
                       keep_core_geoms=False)
    ixs = {d: build_chip_index(table, edge_cap=8, device=d) for d in ("cpu", cuda)}
    assert ixs[cuda].num_heavy_cells > 0
    host = ixs["cpu"].host
    e = np.concatenate([host.cell_edges.reshape(-1, 4), host.heavy_edges.reshape(-1, 4)])
    e = e[np.abs(e).sum(axis=-1) > 0]
    part = np.concatenate([pts, e[:, :2] + host.shift, 0.5 * (e[:, :2] + e[:, 2:]) + host.shift])
    on = {d: pip_join(part, None, grid, 9, chip_index=ixs[d], probe="adaptive", device=d)
          for d in ("cpu", cuda)}
    assert (on["cpu"] >= 0).any()
    np.testing.assert_array_equal(on[cuda], on["cpu"])
