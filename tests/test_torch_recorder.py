"""The port's flight recorder (`mosaic_tpu_torch/obs/recorder.py`):
bounded ring, auto-dump on typed failures, the pinned overhead budget,
and concurrency over the port's telemetry spine.

Mirrors `tests/test_recorder.py` case for case. Beyond the mirror: a dump
the port writes reads back equal in the reference's ``read_trail``, and a
real ``RetryExhausted`` of the port's retry layer leaves a dump file
(``MOSAIC_RECORDER_DIR``) that the port reads back equal to
``RECORDER.last_dump``.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

import mosaic_tpu_torch.obs as obs
from mosaic_tpu.obs import export as ref_export
from mosaic_tpu_torch.obs import export, metrics, recorder
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.runtime.errors import RetryExhausted, TransientDeviceError
from mosaic_tpu_torch.runtime.retry import RetryPolicy, call_with_retry
from torch_obs_fixtures import reset_port_plane


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    yield


FAST = RetryPolicy(
    max_attempts=2, base_delay_s=0.0, max_delay_s=0.0,
    timeout_s=5.0, jitter=0.0,
)


def test_process_recorder_is_installed_by_obs_import():
    assert obs.RECORDER is recorder.RECORDER
    before = len(recorder.RECORDER.events())
    telemetry.record("dispatch_cache_stats", probe="recorder-install")
    ring = recorder.RECORDER.events()
    assert len(ring) >= min(before + 1, recorder.RECORDER.maxlen)
    assert any(
        e.get("probe") == "recorder-install" for e in ring[-5:]
    )


def test_ring_is_bounded_and_keeps_newest():
    r = recorder.FlightRecorder(maxlen=16)
    for i in range(100):
        r({"event": "x", "seq": i})
    ring = r.events()
    assert len(ring) == 16
    assert [e["seq"] for e in ring] == list(range(84, 100))


def test_zero_capacity_disables_recording():
    r = recorder.FlightRecorder(maxlen=0)
    assert not r.enabled
    r({"event": "retry_exhausted", "seq": 1})
    assert r.events() == []
    assert r.auto_dumps == 0


def test_env_knob_sizes_the_ring(monkeypatch):
    monkeypatch.setenv("MOSAIC_RECORDER_N", "7")
    assert recorder.FlightRecorder().maxlen == 7
    monkeypatch.setenv("MOSAIC_RECORDER_N", "not-a-number")
    assert recorder.FlightRecorder().maxlen == recorder.DEFAULT_N


def test_dump_writes_a_readable_jsonl_trail(tmp_path):
    r = recorder.FlightRecorder(maxlen=8)
    r({"event": "span", "seq": 1, "name": "x", "seconds": 0.5})
    r({"event": "transient_retry", "seq": 2, "label": "y"})
    path = str(tmp_path / "dump.jsonl")
    snap = r.dump(path)
    assert len(snap) == 2
    rows = export.read_trail(path)
    # dumps open with the incarnation header (fleet-stitchable)
    assert rows[0]["event"] == "incarnation"
    assert [e["seq"] for e in rows[1:]] == [1, 2]


def test_auto_dump_fires_on_injected_retry_exhausted():
    """The acceptance lane: a real RetryExhausted (no capture scope set
    up beforehand) leaves a frozen snapshot on the PROCESS recorder."""
    r = recorder.RECORDER
    before = r.auto_dumps

    def always_down():
        raise TransientDeviceError("injected: device went away")

    with pytest.raises(RetryExhausted):
        call_with_retry(
            always_down, policy=FAST, label="test.injected",
            sleep=lambda s: None,
        )
    assert r.auto_dumps == before + 1
    assert r.last_dump is not None
    trigger = [
        e for e in r.last_dump if e["event"] == "retry_exhausted"
    ]
    assert trigger and trigger[-1]["label"] == "test.injected"
    # the retries leading up to the failure are IN the snapshot —
    # post-hoc diagnosis without a re-run is the whole point
    assert any(
        e["event"] == "transient_retry"
        and e.get("label") == "test.injected"
        for e in r.last_dump
    )


def test_auto_dump_fires_on_each_trigger_event():
    for ev in sorted(recorder.TRIGGER_EVENTS):
        r = recorder.FlightRecorder(maxlen=8)
        r({"event": "x", "seq": 0})
        r({"event": ev, "seq": 1})
        assert r.auto_dumps == 1, ev
        assert [e["seq"] for e in r.last_dump] == [0, 1], ev


def test_auto_dump_writes_trail_file_when_dir_set(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("MOSAIC_RECORDER_DIR", str(tmp_path))
    r = recorder.FlightRecorder(maxlen=8)
    r({"event": "watchdog_stall", "seq": 42, "site": "stream.scan_step"})
    assert r.last_dump_path is not None
    rows = export.read_trail(r.last_dump_path)
    assert rows[-1]["event"] == "watchdog_stall"
    # the dump announces itself on the spine (recorder_dump) without
    # re-triggering a dump of the dump
    assert r.auto_dumps == 1


def test_auto_dump_file_writes_are_debounced(tmp_path, monkeypatch):
    monkeypatch.setenv("MOSAIC_RECORDER_DIR", str(tmp_path))
    r = recorder.FlightRecorder(maxlen=8, min_dump_interval_s=60.0)
    r({"event": "degraded", "seq": 1})
    r({"event": "degraded", "seq": 2})
    # both triggers snapshot in memory; only the first hits the disk
    assert r.auto_dumps == 2
    assert len(list(tmp_path.iterdir())) == 1


def test_slo_violation_triggers_dump_named_after_the_slo(
    tmp_path, monkeypatch
):
    """An SLO burn-rate breach is a first-class dump trigger, and the
    dump file names the violated SLO and its window — a directory of
    dumps reads as an incident log without opening any file."""
    import os

    monkeypatch.setenv("MOSAIC_RECORDER_DIR", str(tmp_path))
    r = recorder.FlightRecorder(maxlen=8)
    r({"event": "serve_shed", "seq": 6, "reason": "deadline"})
    r({
        "event": "slo_violation", "seq": 7, "slo": "serve.shed",
        "window_s": 60.0, "burn_rate": 10.0,
    })
    assert r.auto_dumps == 1
    assert r.last_dump_path is not None
    name = os.path.basename(r.last_dump_path)
    assert "slo_violation" in name
    assert "serve.shed" in name and "w60s" in name
    # the evidence leading up to the breach is IN the snapshot
    assert any(
        e["event"] == "serve_shed" for e in r.last_dump
    )


def test_one_dump_per_breach_episode(tmp_path, monkeypatch):
    """A breached SLO that stays breached emits ONE violation — so one
    dump — until the burn clears below the hysteresis floor; the flap
    back up is a NEW episode and a new dump."""
    from mosaic_tpu_torch.obs import slo as obs_slo

    monkeypatch.setenv("MOSAIC_RECORDER_DIR", str(tmp_path))
    r = recorder.FlightRecorder(maxlen=64)
    telemetry.add_observer(r.observer)
    try:
        m = obs_slo.SLOMonitor(
            short_window_s=10.0, long_window_s=10.0,
        )
        spec = m.register(obs_slo.SLOSpec(
            name="unit.shed", kind="ratio", objective=0.95,
            min_events=1,
        ))
        m.wire_good(spec, "unit_good")
        m.wire_bad(spec, "unit_bad")
        t0 = 1000.0
        for i in range(10):
            m._ingest(m._handlers["unit_bad"], {"event": "unit_bad"}, t0)
        m.evaluate(t0)          # breach: one violation, one dump
        m.evaluate(t0 + 0.1)    # still breached: no new violation
        m.evaluate(t0 + 0.2)
        assert r.auto_dumps == 1
        # burn clears (window slides past the bad burst) -> re-arm
        m.evaluate(t0 + 50.0)
        for i in range(10):
            m._ingest(
                m._handlers["unit_bad"], {"event": "unit_bad"},
                t0 + 100.0,
            )
        m.evaluate(t0 + 100.0)  # new episode, second dump
        assert r.auto_dumps == 2
    finally:
        telemetry.remove_observer(r.observer)


def test_recorder_dump_event_rides_the_spine():
    r = recorder.FlightRecorder(maxlen=8)
    with telemetry.capture() as events:
        r({"event": "degraded", "seq": 1})
    dumps = [e for e in events if e["event"] == "recorder_dump"]
    assert len(dumps) == 1
    assert dumps[0]["trigger"] == "degraded"
    assert dumps[0]["n_events"] == 1


def test_micro_benchmark_recorder_overhead_within_budget():
    """Installed ``record()`` ≤ 1.15× the bare path (the pinned
    budget). Measured as INTERLEAVED best-of-pairs — alternating
    bare/installed samples so load drift on a shared box hits both
    sides equally instead of biasing whichever phase ran second; the
    recorder's per-event cost is one function call, one deque append,
    one dict getitem, one frozenset test. Both loops are timed in this
    thread's CPU time (``time.thread_time``), which a neighbour process's
    load on a shared box does not inflate as it does wall time."""
    n = 20_000

    def once() -> float:
        t0 = time.thread_time()
        for _ in range(n):
            telemetry.record("dispatch_cache_stats", hits=1)
        return time.thread_time() - t0

    def measure() -> tuple[float, float]:
        bare = installed = float("inf")
        try:
            for _ in range(10):
                recorder.uninstall()
                bare = min(bare, once())
                recorder.install()
                installed = min(installed, once())
        finally:
            recorder.install()
        return bare, installed

    # one full re-measure before failing: a CI neighbor's burst can
    # still skew a single round; a REAL >15% regression fails both
    bare, installed = measure()
    if installed / bare > 1.15:
        b2, i2 = measure()
        if i2 / b2 < installed / bare:
            bare, installed = b2, i2
    ratio = installed / bare
    assert ratio <= 1.15, (
        f"recorder overhead {ratio:.3f}x exceeds the 1.15x budget "
        f"(bare {bare:.4f}s, installed {installed:.4f}s)"
    )


def test_concurrent_record_no_lost_events_and_monotonic_seq():
    """Serve submit threads + the batcher record concurrently: every
    event reaches the observers exactly once, ``seq`` is unique and
    strictly increasing, and the bounded ring survives the load."""
    n_threads, per_thread = 4, 2000
    r = recorder.FlightRecorder(maxlen=512)
    got: list = []
    observers = [r, got.append]
    for o in observers:
        telemetry.add_observer(o)
    label = f"conc-{id(got):x}"
    try:
        barrier = threading.Barrier(n_threads)

        def worker(tid: int) -> None:
            barrier.wait()
            for i in range(per_thread):
                telemetry.record(
                    "transient_retry", label=label, attempt=i,
                    worker=tid,
                )

        threads = [
            threading.Thread(target=worker, args=(t,))  # lint: thread-context-adoption-ok (probes RAW concurrent record() via process-wide observers; adopting sinks would defeat the test)
            for t in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for o in observers:
            telemetry.remove_observer(o)

    mine = [e for e in got if e.get("label") == label]
    assert len(mine) == n_threads * per_thread
    seqs = [e["seq"] for e in mine]
    assert len(set(seqs)) == len(seqs), "seq collision under threads"
    per_worker = {}
    for e in mine:
        per_worker.setdefault(e["worker"], []).append(e["seq"])
    for w, ws in per_worker.items():
        assert ws == sorted(ws), f"worker {w} saw reordered seqs"
    assert len(r.events()) == 512
    # the metrics bridge (installed at obs import) counted every one
    snap = metrics.snapshot()["runtime.transient_retries"]
    total = sum(
        s["value"] for s in snap["series"]
        if s["labels"].get("label") == label
    )
    assert total == n_threads * per_thread


def test_dump_is_json_serializable_with_hostile_payloads(tmp_path):
    r = recorder.FlightRecorder(maxlen=4)
    r({"event": "x", "seq": 1, "payload": object()})
    path = str(tmp_path / "h.jsonl")
    r.dump(path)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    row = rows[-1]  # rows[0] is the incarnation header
    assert row["seq"] == 1 and "object" in row["payload"]


def test_dump_reads_back_equal_in_both_packages(tmp_path):
    r = recorder.FlightRecorder(maxlen=8)
    for i in range(5):
        r({"event": "transient_retry", "seq": i, "ts_mono": 1.0 + i,
           "label": "x", "attempt": i})
    path = str(tmp_path / "d.jsonl")
    snap = r.dump(path)
    rows = export.read_trail(path)
    assert rows == ref_export.read_trail(path)
    assert rows[0]["event"] == "incarnation"
    assert rows[1:] == snap


def test_retry_exhausted_dump_file_reads_back_equal(tmp_path, monkeypatch):
    """What chip_smoke's serving process checks on the card: with
    ``MOSAIC_RECORDER_DIR`` set, a real ``RetryExhausted`` under a span
    leaves a dump whose trigger carries the span's trace id, and the
    file reads back equal to ``RECORDER.last_dump``."""
    monkeypatch.setenv("MOSAIC_RECORDER_DIR", str(tmp_path))
    monkeypatch.setattr(recorder.RECORDER, "_last_file_t", float("-inf"))

    def always_down():
        raise TransientDeviceError("injected: device went away")

    with pytest.raises(RetryExhausted):
        with obs.span("unit.failing") as sp:
            call_with_retry(always_down, policy=FAST, label="unit.dump",
                            sleep=lambda s: None)
    dump = recorder.RECORDER.last_dump
    assert dump[-1]["event"] == "retry_exhausted"
    assert dump[-1]["trace_id"] == sp.context.trace_id
    rows = export.read_trail(recorder.RECORDER.last_dump_path)
    assert rows[0]["event"] == "incarnation"
    assert rows[1:] == dump
