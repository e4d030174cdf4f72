"""The port's SLO registry + multi-window burn-rate monitor
(`mosaic_tpu_torch/obs/slo.py`).

Mirrors `tests/test_slo.py` case for case. Beyond the mirror:
``evaluate_trail`` of the port equals the reference's on the same
trails (the seeded synthetic trail and the mirror's shed storms), and
the default specs read the same ``MOSAIC_SLO_*`` knobs to the same specs.
"""

import dataclasses

import pytest

from mosaic_tpu.obs import slo as ref_slo
from mosaic_tpu_torch.obs import slo
from mosaic_tpu_torch.runtime import telemetry
from torch_obs_fixtures import reset_port_plane, synthetic_trail


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    yield


# ---------------------------------------------------------- window ring


class TestWindowRing:
    def test_totals_within_window_and_expiry(self):
        r = slo.WindowRing(10.0, n_buckets=10)  # 1 s buckets
        r.add(100.2, a=1.0)
        r.add(100.7, a=1.0)
        r.add(105.5, b=1.0)
        assert r.totals(106.0) == (2.0, 1.0)
        # a narrower window excludes the old bucket
        assert r.totals(106.0, window_s=2.0) == (0.0, 1.0)
        # sliding forward expires old buckets without any sweep: at
        # 114.9 only the 105 bucket survives; at 115.0 the window edge
        # (exclusive at lo) drops it too
        assert r.totals(114.9) == (0.0, 1.0)
        assert r.totals(115.0) == (0.0, 0.0)

    def test_slot_reuse_invalidates_stale_bucket(self):
        r = slo.WindowRing(10.0, n_buckets=10)
        r.add(100.5, a=5.0)
        # 110.5 maps to the SAME slot (10 buckets x 1 s): the stale
        # value must be dropped, not accumulated into
        r.add(110.5, b=1.0)
        assert r.totals(110.9) == (0.0, 1.0)

    def test_reset(self):
        r = slo.WindowRing(10.0, n_buckets=4)
        r.add(1.0, a=1.0, b=2.0)
        r.reset()
        assert r.totals(1.0) == (0.0, 0.0)


class TestWindowHistogram:
    def test_windowed_percentile(self):
        h = slo.WindowHistogram(10.0, n_buckets=10)
        for _ in range(99):
            h.observe(100.0, 0.004)
        h.observe(100.0, 5.0)
        # bucket-edge resolution: 0.004 lands in the 0.005 bucket
        assert h.percentile(100.5, 0.5) == 0.005
        assert h.percentile(100.5, 0.999) == 5.0
        # outside the window the samples are gone
        assert h.percentile(200.0, 0.5) is None

    def test_empty_is_none(self):
        h = slo.WindowHistogram(10.0)
        assert h.percentile(0.0, 0.99) is None


# ------------------------------------------------------ burn-rate rules


def _ratio_monitor(short=10.0, long=50.0, **spec_kw):
    m = slo.SLOMonitor(
        short_window_s=short, long_window_s=long, burn_threshold=1.0,
    )
    kw = {"min_events": 1, **spec_kw}
    spec = m.register(slo.SLOSpec(
        name="unit.ratio", kind="ratio", objective=0.95, **kw,
    ))
    m.wire_good(spec, "unit_good")
    m.wire_bad(spec, "unit_bad")
    return m


def _feed(m, event, n, t, **fields):
    hs = m._handlers[event]
    for _ in range(n):
        m._ingest(hs, {"event": event, **fields}, t)


class TestBurnRate:
    def test_short_window_blip_alone_does_not_breach(self):
        """The multi-window rule: a burst that torches the short window
        while the long window still holds budget does NOT page."""
        m = _ratio_monitor()
        _feed(m, "unit_good", 400, 1000.0)  # long-window ballast
        _feed(m, "unit_bad", 10, 1035.0)    # short-window burst
        with telemetry.capture() as events:
            statuses = m.evaluate(1040.0)
        (s,) = statuses
        assert s["burn_short"] == pytest.approx(20.0)   # 100% bad / 5%
        assert s["burn_long"] < 1.0
        assert not s["breached"]
        assert not [e for e in events if e["event"] == "slo_violation"]

    def test_both_windows_over_threshold_breaches_once(self):
        m = _ratio_monitor()
        _feed(m, "unit_good", 400, 1000.0)
        _feed(m, "unit_bad", 30, 1035.0)  # 30/430 long > 5% budget
        with telemetry.capture() as events:
            m.evaluate(1040.0)
            m.evaluate(1041.0)  # still breached: no second violation
            m.evaluate(1042.0)
        violations = [e for e in events if e["event"] == "slo_violation"]
        assert len(violations) == 1
        v = violations[0]
        assert v["slo"] == "unit.ratio" and v["kind"] == "ratio"
        assert v["burn_rate"] >= 1.0 and v["burn_rate_long"] >= 1.0
        assert v["window_s"] == 10.0 and v["long_window_s"] == 50.0

    def test_hysteresis_rearms_only_below_clear_floor(self):
        """Clear (window slides past the burst) then re-breach: a NEW
        episode, a second violation — but never one per evaluation."""
        m = _ratio_monitor(short=10.0, long=10.0)
        _feed(m, "unit_bad", 10, 1000.0)
        with telemetry.capture() as events:
            m.evaluate(1000.0)
            m.evaluate(1005.0)          # breached, no new event
            m.evaluate(1050.0)          # empty window -> clears, re-arms
            _feed(m, "unit_bad", 10, 1100.0)
            m.evaluate(1100.0)          # new episode
        violations = [e for e in events if e["event"] == "slo_violation"]
        assert len(violations) == 2
        (s,) = m.evaluate(1100.5)
        assert s["violations"] == 2 and s["breached"]

    def test_min_events_gate_holds_fire(self):
        m = _ratio_monitor(min_events=10)
        _feed(m, "unit_bad", 3, 1000.0)  # 100% bad but only 3 events
        with telemetry.capture() as events:
            (s,) = m.evaluate(1000.0)
        assert s["burn_short"] is None and not s["breached"]
        assert not [e for e in events if e["event"] == "slo_violation"]

    def test_count_zero_breaches_on_any_event(self):
        m = slo.SLOMonitor(short_window_s=10.0, long_window_s=10.0)
        spec = m.register(slo.SLOSpec(name="unit.cold", kind="count_zero"))
        m.wire_bad(spec, "serve_compile")
        (s,) = m.evaluate(1000.0)
        assert not s["breached"]
        _feed(m, "serve_compile", 1, 1001.0)
        with telemetry.capture() as events:
            (s,) = m.evaluate(1001.0)
        assert s["breached"] and s["burn_short"] == 1.0
        assert [e for e in events if e["event"] == "slo_violation"]

    def test_rate_min_breaches_below_floor(self):
        m = slo.SLOMonitor(short_window_s=10.0, long_window_s=10.0)
        spec = m.register(slo.SLOSpec(
            name="unit.rate", kind="rate_min", rate_min=100.0,
            min_events=1,
        ))
        m.wire_rate(spec, "stream_stage", "points_per_sec",
                    stage="join_loop")
        hs = m._handlers["stream_stage"]
        # wrong stage is ignored entirely
        m._ingest(hs, {"event": "stream_stage", "stage": "compile",
                       "points_per_sec": 1.0}, 1000.0)
        (s,) = m.evaluate(1000.0)
        assert s["burn_short"] is None
        m._ingest(hs, {"event": "stream_stage", "stage": "join_loop",
                       "points_per_sec": 50.0}, 1001.0)
        (s,) = m.evaluate(1001.0)
        assert s["breached"]  # mean 50 under the 100 floor: burn 2.0
        assert s["burn_short"] == pytest.approx(2.0)
        # rate recovers far above the floor -> burn < clear floor,
        # re-arms
        for _ in range(20):
            m._ingest(hs, {"event": "stream_stage", "stage": "join_loop",
                           "points_per_sec": 5000.0}, 1002.0)
        (s,) = m.evaluate(1002.0)
        assert not s["breached"]


# ----------------------------------------------------- observer wiring


class TestObserver:
    def test_observer_routes_and_evaluates_on_cadence(self):
        """Feeding the observer directly (as the spine would) both
        ingests matching events and trips evaluation without any manual
        evaluate() call — eval piggybacks on event arrival."""
        m = _ratio_monitor(short=1.0, long=1.0)
        with telemetry.capture() as events:
            for i in range(10):
                m.observer({"event": "unit_bad", "ts_mono": 1000.0 + i * 0.5})
            # unknown events are a no-op, not an error
            m.observer({"event": "who_knows", "ts_mono": 1001.0})
        assert [e for e in events if e["event"] == "slo_violation"]

    def test_snapshot_shape(self):
        m = _ratio_monitor()
        snap = m.snapshot(1000.0)
        assert snap["short_window_s"] == 10.0
        assert snap["long_window_s"] == 50.0
        assert set(snap["slos"]) == {"unit.ratio"}
        assert snap["slos"]["unit.ratio"]["kind"] == "ratio"


# ----------------------------------------------------- default specs


class TestDefaultSpecs:
    def test_latency_spec_classifies_against_knob(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_SLO_LATENCY_S", "0.01")
        m = slo.SLOMonitor(short_window_s=10.0, long_window_s=10.0)
        specs = slo.register_default_specs(m)
        names = {s.name for s in specs}
        assert {"serve.latency", "serve.shed", "runtime.degraded",
                "serve.cold_compile"} <= names
        hs = m._handlers["serve_request"]
        for i in range(20):
            m._ingest(hs, {"event": "serve_request", "seconds": 0.5,
                           "ts_mono": 1000.0}, 1000.0)
        (lat,) = [
            s for s in m.evaluate(1000.0) if s["slo"] == "serve.latency"
        ]
        assert lat["breached"]  # every request over the 10 ms threshold
        assert lat["p99_s"] is not None

    def test_stream_rate_spec_is_knob_gated(self, monkeypatch):
        m = slo.SLOMonitor(short_window_s=10.0)
        assert not any(
            s.name == "stream.sustained_rate"
            for s in slo.register_default_specs(m)
        )
        monkeypatch.setenv("MOSAIC_SLO_STREAM_RATE_MIN", "1000")
        m2 = slo.SLOMonitor(short_window_s=10.0)
        assert any(
            s.name == "stream.sustained_rate"
            for s in slo.register_default_specs(m2)
        )

    def test_window_and_burn_knobs(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_SLO_WINDOW_S", "30")
        monkeypatch.setenv("MOSAIC_SLO_BURN", "2.5")
        m = slo.SLOMonitor()
        assert m.short_window_s == 30.0
        assert m.long_window_s == 150.0  # 5x the short window
        assert m.burn_threshold == 2.5
        monkeypatch.setenv("MOSAIC_SLO_WINDOW_S", "not-a-number")
        assert slo.SLOMonitor().short_window_s == slo.DEFAULT_WINDOW_S


# ----------------------------------------------------- trail replay


def _trail(n_good, n_bad, t0=100.0):
    events = [
        {"event": "serve_request", "seconds": 0.001,
         "ts_mono": t0 + i * 0.01, "seq": i}
        for i in range(n_good)
    ]
    events += [
        {"event": "serve_shed", "reason": "deadline",
         "ts_mono": t0 + 1.0 + i * 0.01, "seq": n_good + i}
        for i in range(n_bad)
    ]
    return events


class TestEvaluateTrail:
    def test_clean_trail_is_ok(self):
        verdict = slo.evaluate_trail(_trail(50, 0))
        assert verdict["ok"] and verdict["breached"] == []
        assert not verdict["verdicts"]["serve.shed"]["breached"]

    def test_shed_storm_breaches_and_lands_in_capture(self):
        """The --slo lane contract: a breach during replay emits a real
        slo_violation INSIDE the caller's capture, so the bench trail
        itself records the verdict."""
        with telemetry.capture() as events:
            verdict = slo.evaluate_trail(_trail(50, 50))
        assert not verdict["ok"]
        assert verdict["breached"] == ["serve.shed"]
        v = [e for e in events if e["event"] == "slo_violation"]
        assert len(v) == 1 and v[0]["slo"] == "serve.shed"

    def test_non_dict_rows_are_tolerated(self):
        events = _trail(20, 0) + ["garbage", None]
        assert slo.evaluate_trail(events)["ok"]


# ------------------------------------------------ equal to the reference


@pytest.mark.parametrize("case", ["clean", "storm", "synthetic", "latency"])
def test_evaluate_trail_equals_the_reference(case, monkeypatch):
    monkeypatch.setenv("MOSAIC_SLO_LATENCY_S", "0.05")
    events = {
        "clean": lambda: _trail(50, 0),
        "storm": lambda: _trail(50, 50),
        "synthetic": lambda: synthetic_trail(seed=7),
        "latency": lambda: [
            {"event": "serve_request", "seconds": 0.02 * (i % 7),
             "ts_mono": 10.0 + i * 0.05, "seq": i}
            for i in range(200)
        ],
    }[case]()
    with telemetry.capture() as port_events:
        port = slo.evaluate_trail(events)
    ref = ref_slo.evaluate_trail(events)
    assert port == ref
    assert sorted(e["slo"] for e in port_events
                  if e["event"] == "slo_violation") == ref["breached"]


def test_default_specs_equal_the_reference(monkeypatch):
    monkeypatch.setenv("MOSAIC_SLO_LATENCY_S", "0.25")
    monkeypatch.setenv("MOSAIC_SLO_SHED_MAX", "0.1")
    monkeypatch.setenv("MOSAIC_SLO_STREAM_RATE_MIN", "500")
    port = slo.register_default_specs(slo.SLOMonitor(short_window_s=10.0))
    ref = ref_slo.register_default_specs(ref_slo.SLOMonitor(short_window_s=10.0))
    assert [dataclasses.asdict(s) for s in port] \
        == [dataclasses.asdict(s) for s in ref]
