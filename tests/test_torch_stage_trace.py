"""Stage timing of the port (`mosaic_tpu_torch/obs/trace.py`): the stage
spans of `pip_join` and of the stream loop, their profiler ranges, their
device times and the bridge's two counters, on the CPU.

While a torch profiler records (or the operator's switch is on) the host
entry and the stream loop record their stages under ``join.pip`` and
``stream.run``; otherwise they emit the reference's trail event for
event and make no profiler or CUDA-event call."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mosaic_tpu.core.geometry import wkt as ref_wkt
from mosaic_tpu.core.index import (
    CustomIndexSystem as RefCustomIndexSystem,
    GridConf as RefGridConf,
)
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.obs import health as ref_health
from mosaic_tpu.obs import slo as ref_slo
from mosaic_tpu.runtime import telemetry as ref_telemetry
from mosaic_tpu.sql.join import (
    build_chip_index as ref_build_chip_index,
    pip_join as ref_pip_join,
)
from mosaic_tpu.sql.stream import (
    StreamJoin as RefStreamJoin,
    ring_from_host as ref_ring_from_host,
)
from mosaic_tpu_torch.core.geometry.wkt import from_wkt
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf, H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.obs import export, metrics, trace
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql.join import build_chip_index, pip_join
from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host
from torch_obs_fixtures import reset_port_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WKT = ["POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))"]
N, B, K = 4096, 2048, 3

JOIN_STAGES = ("join.pip.h2d", "join.pip.cells", "join.pip.counts",
               "join.pip.prepare", "join.pip.probe", "join.pip.d2h")
STREAM_STAGES = ("stream.assign", "stream.join", "stream.fold_pull")
TIMED = ("join.pip.prepare", "join.pip.cells", "join.pip.probe", "stream.assign",
         "stream.join")
#: the exact lane's stages (``recheck=True``)
RECHECK_STAGES = ("join.pip.narrow", "join.pip.oracle")
NYC_WKT = ["POLYGON ((-74.02 40.70, -73.90 40.71, -73.92 40.80, -73.97 40.76, "
           "-74.00 40.79, -74.02 40.70))"]


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    trace.stage_timing(False)
    yield
    trace.stage_timing(False)


def _inputs():
    rng = np.random.default_rng(0)
    pts = rng.uniform((-25, -25), (35, 20), (N, 2))
    batches = [rng.uniform((-25, -25), (35, 20), (B, 2)) for _ in range(K)]
    return pts, batches


@pytest.fixture(scope="module")
def port():
    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    ix = build_chip_index(
        tessellate(from_wkt(WKT), grid, 3, keep_core_geoms=False), device="cpu"
    )
    pts, batches = _inputs()
    sj = StreamJoin(ix, grid, 3, prefetch=True)
    ring = ring_from_host(batches, device="cpu")
    sj.compile(ring, K)
    return grid, ix, pts, sj, ring


@pytest.fixture(scope="module")
def h3port():
    """An H3 index at res 9 and points over its box: a join with cell
    margins, so the exact lane runs its narrow re-join."""
    h3 = H3IndexSystem()
    ix = build_chip_index(
        tessellate(from_wkt(NYC_WKT), h3, 9, keep_core_geoms=False), device="cpu"
    )
    rng = np.random.default_rng(3)
    pts = rng.uniform((-74.03, 40.69), (-73.89, 40.81), (N, 2))
    return h3, ix, pts


def _h3_join(h3port, recheck):
    h3, ix, pts = h3port
    return pip_join(pts, None, h3, 9, chip_index=ix, recheck=recheck, probe="adaptive",
                    device="cpu")


@pytest.fixture(scope="module")
def reference_trails():
    """The reference's trail (event, name or stage) of the same calls,
    from monitors as fresh as the port's (an earlier file in the same
    process may leave the reference's health unhealthy, and its first
    evaluation here would add transitions to the trail)."""
    ref_health.MONITOR.reset()
    ref_slo.MONITOR.reset()
    grid = RefCustomIndexSystem(RefGridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    ix = ref_build_chip_index(
        ref_tessellate(ref_wkt.from_wkt(WKT), grid, 3, keep_core_geoms=False)
    )
    pts, batches = _inputs()
    with ref_telemetry.capture() as join_ev:
        ref_pip_join(pts, None, grid, 3, chip_index=ix)
    sj = RefStreamJoin(ix, grid, 3, prefetch=True)
    ring = ref_ring_from_host(batches)
    sj.compile(ring, K)
    with ref_telemetry.capture() as stream_ev:
        sj.run(ring, K)
    return _names(join_ev), _names(stream_ev)


def _names(events):
    return [(e["event"], e.get("name") or e.get("stage")) for e in events]


def _spans(events, name):
    return [e for e in events if e["event"] == "span" and e["name"] == name]


def _join(port):
    grid, ix, pts, _, _ = port
    return pip_join(pts, None, grid, 3, chip_index=ix, device="cpu")


def _run(port):
    _, _, _, sj, ring = port
    return sj.run(ring, K)


@pytest.fixture
def counted(monkeypatch):
    """Counts of ``record_function`` ranges entered and CUDA events made."""
    calls = {"record_function": 0, "cuda_event": 0}
    real_rf = torch.autograd.profiler.record_function

    class CountedRange(real_rf):
        def __init__(self, *a, **k):
            calls["record_function"] += 1
            super().__init__(*a, **k)

    def event(*a, **k):
        calls["cuda_event"] += 1
        raise AssertionError("a CUDA event on the CPU path")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", CountedRange)
    monkeypatch.setattr(torch.cuda, "Event", event)
    return calls


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.capture() as events:
            out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    return out, events, ranges


def _counter(name, stage):
    return metrics.REGISTRY.counter(name).value(stage=stage)


def _stage_counters():
    """The stage timing's counters as the registry holds them now."""
    snap = metrics.snapshot()
    return {k: snap.get(k) for k in (
        "trace.stage_device_seconds", "trace.stage_points", "join.recheck_rows")}


# --------------------------------------------------- under the profiler


def test_profiled_pip_join_records_its_stages(port, tmp_path):
    want = _join(port)
    out, events, ranges = _profiled(lambda: _join(port), tmp_path)
    np.testing.assert_array_equal(out, want)
    (root,) = _spans(events, "join.pip")
    for name in JOIN_STAGES:
        spans = _spans(events, name)
        assert spans, name
        assert all(s["parent_id"] == root["span_id"] for s in spans), name
        assert all(s["trace_id"] == root["trace_id"] for s in spans), name
        assert name in ranges, name
    assert "join.pip" in ranges
    # one copy, the f64 points: the device shifts and casts them
    assert [s["bytes"] for s in _spans(events, "join.pip.h2d")] == [N * 16]
    for name in ("join.pip.prepare", "join.pip.cells", "join.pip.probe"):
        (s,) = _spans(events, name)
        assert s["device_s"] > 0 and s["points"] == N
        assert _counter("trace.stage_device_seconds", name) == pytest.approx(s["device_s"])
        assert _counter("trace.stage_points", name) == N
    for name in ("join.pip.h2d", "join.pip.counts", "join.pip.d2h"):
        assert all("device_s" not in s for s in _spans(events, name)), name


def test_profiled_stream_run_records_its_stages(port, tmp_path):
    want = _run(port)
    res, events, ranges = _profiled(lambda: _run(port), tmp_path)
    assert (res.checksum, res.matches, res.overflow) == (
        want.checksum, want.matches, want.overflow)
    (root,) = _spans(events, "stream.run")
    for name in STREAM_STAGES:
        spans = _spans(events, name)
        assert spans and all(s["parent_id"] == root["span_id"] for s in spans), name
        assert name in ranges, name
    assert "stream.run" in ranges
    # every batch's join; its assigns with the prefetch (one past the last)
    counts = {"stream.assign": K + 1, "stream.join": K}
    for name, n in counts.items():
        spans = _spans(events, name)
        assert len(spans) == n
        assert all(s["device_s"] > 0 and s["points"] == B for s in spans)
        assert _counter("trace.stage_device_seconds", name) == pytest.approx(
            sum(s["device_s"] for s in spans))
        assert _counter("trace.stage_points", name) == n * B
    assert "device_s" not in _spans(events, "stream.fold_pull")[0]
    # an operator scrapes the counters like every other
    text = export.prometheus_text()
    assert 'trace_stage_device_seconds{stage="stream.join"}' in text
    assert 'trace_stage_points{stage="stream.assign"}' in text


def test_profiled_exact_join_records_the_recheck_stages(h3port, tmp_path):
    want = _h3_join(h3port, True)
    out, events, ranges = _profiled(lambda: _h3_join(h3port, True), tmp_path)
    np.testing.assert_array_equal(out, want)
    (root,) = _spans(events, "join.pip")
    for name in JOIN_STAGES + RECHECK_STAGES:
        (s,) = _spans(events, name)
        assert s["parent_id"] == root["span_id"], name
        assert name in ranges, name
    (narrow,) = _spans(events, "join.pip.narrow")
    (oracle,) = _spans(events, "join.pip.oracle")
    assert narrow["device_s"] > 0 and narrow["points"] == N
    assert 0 < narrow["rows"] < N and 0 < oracle["rows"] < N
    assert "device_s" not in oracle
    assert _counter("trace.stage_device_seconds", "join.pip.narrow") == pytest.approx(
        narrow["device_s"])
    rows = metrics.REGISTRY.counter("join.recheck_rows")
    assert rows.value(lane="band") == narrow["rows"]
    assert rows.value(lane="oracle") == oracle["rows"]


def test_profiled_float32_lane_keeps_its_trail(h3port, tmp_path):
    _, events, ranges = _profiled(lambda: _h3_join(h3port, False), tmp_path)
    (root,) = _spans(events, "join.pip")
    children = {e["name"] for e in events
                if e["event"] == "span" and e.get("parent_id") == root["span_id"]}
    assert children == set(JOIN_STAGES)
    assert not ranges & set(RECHECK_STAGES)
    assert "join.recheck_rows" not in metrics.snapshot()


def test_exact_join_off_records_no_recheck_stage(h3port, counted):
    assert not trace.stage_timing_on()
    before = _stage_counters()
    with telemetry.capture() as events:
        _h3_join(h3port, True)
    for name in JOIN_STAGES + RECHECK_STAGES:
        assert not _spans(events, name), name
    assert counted == {"record_function": 0, "cuda_event": 0}
    assert _stage_counters() == before


# ------------------------------------------------------------ switched off


def test_off_trail_is_the_references_and_touches_no_profiler(
    port, reference_trails, counted
):
    join_ref, stream_ref = reference_trails
    assert not trace.stage_timing_on()
    before = _stage_counters()
    with telemetry.capture() as join_ev:
        _join(port)
    with telemetry.capture() as stream_ev:
        _run(port)
    assert _names(join_ev) == join_ref
    assert _names(stream_ev) == stream_ref
    assert counted == {"record_function": 0, "cuda_event": 0}
    # the registry is process-wide: what matters is that these calls
    # added nothing to it
    assert _stage_counters() == before


def test_switch_turns_the_stages_on_without_a_profiler(port, counted):
    trace.stage_timing(True)
    assert trace.stage_timing_on()
    with telemetry.capture() as events:
        _join(port)
        _run(port)
    for name in JOIN_STAGES + STREAM_STAGES:
        assert _spans(events, name), name
    for name in RECHECK_STAGES:
        assert not _spans(events, name), name
    for name in TIMED:
        assert all(s["device_s"] > 0 for s in _spans(events, name)), name
    assert counted["record_function"] > 0 and counted["cuda_event"] == 0
    trace.stage_timing(False)
    with telemetry.capture() as events:
        _join(port)
    assert not _spans(events, "join.pip.cells")


def test_environment_sets_the_switch_at_import():
    code = ("from mosaic_tpu_torch.obs import trace\n"
            "print(trace.stage_timing_on())\n")
    for value, want in (("1", "True"), ("0", "False")):
        env = {**os.environ, "MOSAIC_TRACE_STAGES": value}
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == want


def test_without_torch_loaded_the_stages_stay_off(monkeypatch):
    monkeypatch.delitem(sys.modules, "torch")
    assert not trace.stage_timing_on()
    with telemetry.capture() as events:
        with trace.stage_span("join.pip.h2d", bytes=1):
            pass
    assert events == []


# ------------------------------------------------------------ the spans


def test_detached_span_opens_no_range(counted):
    trace.stage_timing(True)
    with telemetry.capture() as events:
        trace.start_span("serve.request", detached=True).end()
        assert counted["record_function"] == 0
        with trace.span("join.pip"):
            pass
    assert counted["record_function"] == 1
    assert [e["name"] for e in events] == ["serve.request", "join.pip"]


def test_nothing_opens_while_a_graph_is_captured(monkeypatch, counted):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    trace.stage_timing(True)
    with telemetry.capture() as events:
        with trace.span("serve.dispatch"):
            with trace.stage_span("stream.join", device=torch.device("cpu"), points=4):
                pass
    assert counted == {"record_function": 0, "cuda_event": 0}
    assert [e["name"] for e in events] == ["serve.dispatch"]


def test_device_stage_without_an_owner_is_a_plain_span():
    trace.stage_timing(True)
    with telemetry.capture() as events:
        with trace.span("stream.durable_run"):
            with trace.stage_span("stream.assign", device=torch.device("cpu"), points=4):
                pass
    (s,) = _spans(events, "stream.assign")
    assert "device_s" not in s and "points" not in s
    assert "trace.stage_device_seconds" not in metrics.snapshot()


def test_owner_that_raises_reads_no_device_time():
    trace.stage_timing(True)
    with telemetry.capture() as events:
        with pytest.raises(RuntimeError):
            with trace.span("stream.run"), trace.device_stages():
                with trace.stage_span("stream.join", device=torch.device("cpu"), points=4):
                    pass
                raise RuntimeError("lost")
    (s,) = _spans(events, "stream.join")
    (root,) = _spans(events, "stream.run")
    assert "device_s" not in s and s["parent_id"] == root["span_id"]
    assert root["error"] == "RuntimeError"
    assert "trace.stage_device_seconds" not in metrics.snapshot()


def test_stage_span_records_its_seconds_when_it_closes():
    trace.stage_timing(True)
    with telemetry.capture() as events:
        with trace.span("join.pip") as root, trace.device_stages():
            with trace.stage_span("join.pip.cells", device=torch.device("cpu"), points=8):
                pass
            # the stage left the stack: the next stage is a sibling
            with trace.stage_span("join.pip.counts"):
                pass
            assert trace.current_context() == root.context
    cells, counts = _spans(events, "join.pip.cells"), _spans(events, "join.pip.counts")
    assert cells[0]["parent_id"] == counts[0]["parent_id"] == root.context.span_id
    assert 0 <= cells[0]["device_s"] <= cells[0]["seconds"] + 1e-6
    # the owner records its stages when it ends, before its own span
    assert [e["name"] for e in events] == ["join.pip.counts", "join.pip.cells", "join.pip"]
