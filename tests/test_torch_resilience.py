"""The port's runtime resilience layer against the JAX package's.

Mirrors `tests/test_resilience.py` (the primitives and the `pip_join`
half) on `mosaic_tpu_torch` with `device="cpu"`: backoff, classification,
retry, exhaustion, fallback, capacity escalation, fault sites and cap
clamps; `pip_join` under forced overflow, forced tier-2 overflow and
transient faults returns ids bit-identical to the clean run (which
equals the reference's), and past its retry budget a `DegradedResult`
equal to the f64 host oracle. The port's own rule: its device errors
(`DeviceUnavailable`, a kernel that does not build or launch, a CUDA
error) are never transient and propagate out of `pip_join` undegraded.
The watchdog, the spans and the telemetry helpers are covered too.
"""

import random
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.runtime import is_transient as ref_is_transient
from mosaic_tpu.runtime import telemetry as ref_telemetry
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.datasets import random_points, synthetic_zones
from mosaic_tpu_torch.dispatch import guarded_call
from mosaic_tpu_torch.obs import trace
from mosaic_tpu_torch.runtime import (
    CapacityOverflow,
    DegradedResult,
    EscalationPolicy,
    KernelCompileError,
    KernelLaunchError,
    RetryExhausted,
    RetryPolicy,
    StalledDeviceError,
    TransientDeviceError,
    backoff_delays,
    call_with_retry,
    faults,
    is_transient,
    run_escalating,
    telemetry,
    watchdog,
    with_retry,
)
from mosaic_tpu_torch.sql.join import (
    OVERFLOW,
    build_chip_index,
    host_join,
    pip_join,
    pip_join_points,
)

RES = 7
BBOX = (-74.05, 40.60, -73.85, 40.78)
N_POINTS = 1200
F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    """Zones + a chip index with a tiny edge_cap so heavy (tier-2) cells
    exist, points, and the clean join (equal to the reference's)."""
    h3 = H3IndexSystem()
    zones = synthetic_zones(3, 3, bbox=BBOX)
    index = build_chip_index(
        tessellate(zones, h3, RES, keep_core_geoms=False), edge_cap=8, device="cpu"
    )
    assert index.num_heavy_cells > 0
    pts = random_points(N_POINTS, bbox=BBOX, seed=5)
    clean = pip_join(pts, None, h3, RES, chip_index=index, recheck=False,
                     cell_dtype=F64, device="cpu")
    assert (clean >= 0).any() and (clean != OVERFLOW).all()
    return h3, index, pts, clean


def join(problem, **kw):
    h3, index, pts, _ = problem
    kw.setdefault("recheck", False)
    kw.setdefault("cell_dtype", F64)
    return pip_join(pts, None, h3, RES, chip_index=index, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference():
    """The reference's index over the same zones (its own build)."""
    ix = RJ.build_chip_index(
        ref_tessellate(ref_zones(3, 3, bbox=BBOX), RefH3(), RES, keep_core_geoms=False),
        edge_cap=8,
    )
    return ix


def test_clean_join_equals_reference(problem, reference):
    h3, index, pts, clean = problem
    want = np.asarray(RJ.pip_join(pts, None, RefH3(), RES, chip_index=reference,
                                  recheck=False))
    np.testing.assert_array_equal(clean, want)


# ------------------------------------------------------------ primitives


def test_backoff_delays_grow_and_cap():
    pol = RetryPolicy(base_delay_s=1.0, max_delay_s=4.0, jitter=0.0)
    d = backoff_delays(pol)
    assert [next(d) for _ in range(4)] == [1.0, 2.0, 4.0, 4.0]


def test_backoff_seeded_jitter_is_reproducible():
    pol = RetryPolicy(base_delay_s=1.0, jitter=0.5)
    a = backoff_delays(pol, rng=random.Random(7))
    b = backoff_delays(pol, rng=random.Random(7))
    first = [next(a) for _ in range(3)]
    assert first == [next(b) for _ in range(3)]
    assert all(0.5 <= x / y <= 1.5 for x, y in zip(first, [1.0, 2.0, 2.0]))


#: plain exceptions both packages classify by type and text (each
#: package's own TransientDeviceError is transient by type)
TRANSIENT_CASES = [
    RuntimeError("remote_compile: HTTP 500"),
    ValueError("bad argument"),
    RuntimeError("shape mismatch"),
    TypeError("nope"),
    RuntimeError("connection reset by peer"),
]


@pytest.mark.parametrize("exc", TRANSIENT_CASES, ids=repr)
def test_is_transient_agrees_with_reference(exc):
    assert is_transient(exc) == ref_is_transient(exc)


def test_is_transient_classification():
    assert is_transient(TransientDeviceError("x"))
    assert is_transient(StalledDeviceError("x", site="s"))
    assert is_transient(RuntimeError("remote_compile: HTTP 500"))
    assert not is_transient(ValueError("bad argument"))
    assert not is_transient(RuntimeError("shape mismatch"))
    assert not is_transient(TypeError("nope"))


#: the port's device errors: never transient, whatever their text says —
#: the reference would retry the last three (their text carries
#: "unavailable" or "tunnel" markers)
DEVICE_ERRORS = [
    DeviceUnavailable("no CUDA card available"),
    KernelCompileError("nvcc failed: remote compile unavailable"),
    KernelLaunchError("pip_heavy_tiled: CUDA launch failed with cudaError 46"),
    RuntimeError("CUDA error: all CUDA-capable devices are busy or unavailable"),
    RuntimeError("CUDA error: an illegal memory access was encountered (tunnel)"),
]


@pytest.mark.parametrize("exc", DEVICE_ERRORS, ids=lambda e: type(e).__name__)
def test_port_device_errors_are_never_transient(exc):
    assert not is_transient(exc)


def test_reference_would_retry_what_the_port_refuses():
    """The refusal is the port's own rule: the reference's text markers
    accept these."""
    assert ref_is_transient(DEVICE_ERRORS[0])
    assert ref_is_transient(DEVICE_ERRORS[3])


def test_call_with_retry_recovers_and_telemetry():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientDeviceError("boom")
        return 42

    with telemetry.capture() as ev:
        out = call_with_retry(flaky, policy=RetryPolicy(base_delay_s=0.0), label="t")
    assert out == 42 and calls["n"] == 3
    assert [e["event"] for e in ev] == ["transient_retry", "transient_retry"]
    assert ev[0]["attempt"] == 1 and ev[1]["attempt"] == 2
    assert ev[0]["seq"] < ev[1]["seq"]


def test_call_with_retry_nontransient_raises_immediately():
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        call_with_retry(bad, policy=RetryPolicy(base_delay_s=0.0))
    assert calls["n"] == 1


def test_call_with_retry_exhausts_typed():
    def always():
        raise TransientDeviceError("down")

    with telemetry.capture() as ev:
        with pytest.raises(RetryExhausted) as ei:
            call_with_retry(always, policy=RetryPolicy(max_attempts=2, base_delay_s=0.0))
    assert ei.value.attempts == 2
    assert isinstance(ei.value.last, TransientDeviceError)
    assert ev[-1]["event"] == "retry_exhausted"


def test_call_with_retry_fallback_is_degraded():
    def always():
        raise TransientDeviceError("down")

    out = call_with_retry(
        always,
        policy=RetryPolicy(max_attempts=2, base_delay_s=0.0),
        fallback=lambda: np.arange(4),
    )
    assert isinstance(out, DegradedResult) and out.degraded
    np.testing.assert_array_equal(np.asarray(out), np.arange(4))
    assert int(out.sum()) == 6
    assert out[:2].attempts == 2  # views keep the flag


def test_with_retry_decorator():
    calls = {"n": 0}

    @with_retry(policy=RetryPolicy(base_delay_s=0.0))
    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 2:
            raise TransientDeviceError("boom")
        return x + 1

    assert flaky(1) == 2 and calls["n"] == 2


def test_run_escalating_grows_to_exact():
    seen = []

    def attempt(caps):
        seen.append(dict(caps))
        return caps["cap"]

    with telemetry.capture() as ev:
        out, caps = run_escalating(
            attempt, {"cap": 8}, {"cap": 1024},
            overflow_count=lambda c: 0 if c >= 32 else 32 - c,
            stage="unit",
        )
    assert out == 32 and caps["cap"] == 32
    assert [c["cap"] for c in seen] == [8, 16, 32]
    kinds = [e["event"] for e in ev]
    assert kinds.count("capacity_overflow") == 2
    assert kinds[-1] == "escalation_resolved"


def test_run_escalating_ceiling_raises_typed():
    with pytest.raises(CapacityOverflow) as ei:
        run_escalating(
            lambda caps: caps["cap"], {"cap": 8}, {"cap": 16},
            overflow_count=lambda c: 1, stage="unit",
        )
    assert ei.value.stage == "unit" and ei.value.overflow_count == 1


def test_run_escalating_attempt_budget_raises_typed():
    with pytest.raises(CapacityOverflow):
        run_escalating(
            lambda caps: caps["cap"], {"cap": 8}, {"cap": 1 << 40},
            overflow_count=lambda c: 1,
            policy=EscalationPolicy(max_attempts=3),
        )


def test_faults_site_filtering():
    with faults.transient_errors(5, sites=("other.site",)):
        faults.maybe_fail("this.site")  # no match: must not raise
    with faults.transient_errors(1, sites=("knn.*",)):
        with pytest.raises(TransientDeviceError):
            faults.maybe_fail("knn.pair_distances")
        faults.maybe_fail("knn.pair_distances")  # budget of 1 spent


def test_faults_skip_first_and_trips():
    with faults.transient_errors(1, sites=("a",), skip_first=2) as plan:
        faults.maybe_fail("a")
        faults.maybe_fail("a")
        with pytest.raises(TransientDeviceError):
            faults.maybe_fail("a")
    assert plan.trips == ["a"] and not faults.active()


def test_faults_clamp_caps_noop_without_plan():
    caps = {"found_cap": 512, "heavy_cap": None}
    assert faults.clamp_caps(caps) == caps
    with telemetry.capture() as ev:
        with faults.shrink_caps(found_cap=8, heavy_cap=8):
            out = faults.clamp_caps(caps)
    assert out == {"found_cap": 8, "heavy_cap": 8}
    assert ev[0]["event"] == "caps_clamped"
    with ref_faults.shrink_caps(found_cap=8, heavy_cap=8):
        assert ref_faults.clamp_caps(caps) == out


def test_faults_corrupt_batches_poisons_a_copy():
    batch = np.ones((5, 2))
    with faults.corrupt_batches(2, sites=("stream.admit",)):
        out = faults.maybe_corrupt("stream.admit", batch)
        same = faults.maybe_corrupt("other", batch)
    assert np.isnan(out[:2]).all() and (out[2:] == 1).all()
    assert same is batch and (batch == 1).all()


# ------------------------------------------------ pip_join under faults


def test_pip_join_forced_overflow_escalates_bit_identical(problem, reference):
    h3, index, pts, clean = problem
    with telemetry.capture() as ev:
        with faults.shrink_caps(found_cap=128, heavy_cap=32):
            out = join(problem)
    np.testing.assert_array_equal(out, clean)
    kinds = [e["event"] for e in ev if e["event"] != "span"]
    assert "capacity_overflow" in kinds
    assert kinds[-1] == "escalation_resolved"
    # the same trail as the reference under the same plan
    with ref_telemetry.capture() as rev:
        with ref_faults.shrink_caps(found_cap=128, heavy_cap=32):
            RJ.pip_join(pts, None, RefH3(), RES, chip_index=reference, recheck=False)

    def trail(events):
        return [(e["event"], e.get("caps"), e.get("overflow")) for e in events
                if e["event"] in ("capacity_overflow", "escalation_resolved")]

    assert trail(ev) == trail(rev)


def test_pip_join_forced_tier2_overflow_bit_identical(problem):
    with telemetry.capture() as ev:
        with faults.force_tier2_overflow(heavy_cap=8):
            out = join(problem)
    np.testing.assert_array_equal(out, problem[3])
    over = [e for e in ev if e["event"] == "capacity_overflow"]
    assert over and all(e["caps"]["heavy_cap"] >= 8 for e in over)


@pytest.mark.parametrize("recheck", [False, True])
def test_pip_join_transient_faults_retry_bit_identical(problem, recheck):
    clean = join(problem, recheck=recheck, cell_dtype=torch.float32)
    with telemetry.capture() as ev:
        with faults.transient_errors(2, sites=("pip_join.device",)):
            out = join(problem, recheck=recheck, cell_dtype=torch.float32)
    assert not isinstance(out, DegradedResult)  # retries recovered
    np.testing.assert_array_equal(out, clean)
    assert [e["event"] for e in ev].count("transient_retry") == 2


@pytest.mark.parametrize("recheck", [False, True])
def test_pip_join_retry_exhausted_degrades_to_host_oracle(problem, recheck):
    """On the CPU the host oracle answers past the retry budget; on the
    card `RetryExhausted` propagates instead (`test_torch_kernels_gpu`)."""
    h3, index, pts, clean = problem
    with telemetry.capture() as ev:
        with faults.transient_errors(50, sites=("pip_join.device",)):
            out = join(problem, recheck=recheck)
    assert isinstance(out, DegradedResult) and out.degraded
    assert out.attempts >= 3 and "exhausted" in out.reason
    np.testing.assert_array_equal(np.asarray(out), host_join(pts, index.host, h3, RES))
    kinds = [e["event"] for e in ev]
    assert kinds.index("transient_retry") < kinds.index("degraded")


def test_pip_join_batched_degradation_is_merged(problem):
    h3, index, pts, _ = problem
    with faults.transient_errors(50, sites=("pip_join.device",)):
        out = join(problem, batch_size=500)
    assert isinstance(out, DegradedResult)
    assert out.detail == {"degraded_batches": 3}
    np.testing.assert_array_equal(np.asarray(out), host_join(pts, index.host, h3, RES))


@pytest.mark.parametrize("exc", DEVICE_ERRORS, ids=lambda e: type(e).__name__)
@pytest.mark.parametrize("recheck", [False, True])
def test_pip_join_device_errors_propagate_undegraded(problem, exc, recheck):
    """The port's device errors are raised at the device site and leave
    `pip_join` as they are: no retry, no host answer."""
    with telemetry.capture() as ev:
        with faults.transient_errors(1, sites=("pip_join.device",),
                                     exc_factory=lambda site: exc):
            with pytest.raises(type(exc)) as ei:
                join(problem, recheck=recheck)
    assert ei.value is exc
    kinds = {e["event"] for e in ev}
    assert not kinds & {"transient_retry", "degraded", "retry_exhausted"}


def test_pip_join_points_still_reports_overflow_at_low_level(problem, reference):
    """The low-level API keeps the documented -2 contract; only the
    managed wrapper escalates. Same rows as the reference's."""
    h3, index, pts, _ = problem
    cells = h3.point_to_cell(torch.from_numpy(pts), RES)
    shifted = torch.from_numpy((pts - index.host.shift).astype(np.float32))
    out = pip_join_points(shifted, cells, index, found_cap=8).numpy()
    assert (out == OVERFLOW).any()
    ref_out = np.asarray(RJ.pip_join_points(
        jnp.asarray(shifted.numpy()), jnp.asarray(cells.numpy()), reference,
        found_cap=8))
    np.testing.assert_array_equal(out, ref_out)


def test_compact_block_must_be_multiple_of_128(problem):
    h3, index, pts, _ = problem
    cells = h3.point_to_cell(torch.from_numpy(pts), RES)
    shifted = torch.from_numpy((pts - index.host.shift).astype(np.float32))
    with pytest.raises(ValueError, match=r"compact_block must be a multiple of 128"):
        pip_join_points(shifted, cells, index, compaction="mxu", compact_block=200)


def test_probe_route_event(problem):
    with telemetry.capture() as ev:
        join(problem, probe="adaptive")
    (r,) = [e for e in ev if e["event"] == "probe_route"]
    assert r["probe"] == "adaptive" and r["n"] == N_POINTS
    assert r["found"] == r["light"] + r["convex"] and r["heavy"] > 0


# ----------------------------------------------------------- the watchdog


def _join_watchdog_workers(site):
    for t in threading.enumerate():
        if t.name == f"mosaic-watchdog:{site}":
            t.join(timeout=30)
            assert not t.is_alive()


def test_watchdog_deadline_resolution(monkeypatch):
    site = "pip_join.device"
    assert watchdog.env_name(site) == "MOSAIC_WATCHDOG_PIP_JOIN_DEVICE"
    monkeypatch.delenv("MOSAIC_WATCHDOG_S", raising=False)
    monkeypatch.delenv("MOSAIC_WATCHDOG_PIP_JOIN_DEVICE", raising=False)
    assert watchdog.deadline_for(site) is None
    assert watchdog.deadline_for(site, 3.0) == 3.0
    monkeypatch.setenv("MOSAIC_WATCHDOG_S", "2")
    assert watchdog.deadline_for(site, 3.0) == 2.0
    monkeypatch.setenv("MOSAIC_WATCHDOG_PIP_JOIN_DEVICE", "0")
    assert watchdog.deadline_for(site, 3.0) is None


def test_watchdog_inline_without_deadline(monkeypatch):
    monkeypatch.delenv("MOSAIC_WATCHDOG_S", raising=False)
    assert watchdog.guard("unit.inline", threading.current_thread) is threading.current_thread()


def test_watchdog_worker_carries_sinks_and_span():
    with telemetry.capture() as ev:
        with trace.span("outer") as sp:
            watchdog.guard("unit.worker", lambda: telemetry.record("inside"),
                           default_s=30.0)
    (inside,) = [e for e in ev if e["event"] == "inside"]
    assert inside["span_id"] == sp.context.span_id


def test_watchdog_raises_stalled():
    with telemetry.capture() as ev:
        with faults.stalls(0.5, sites=("unit.stall",)):
            with pytest.raises(StalledDeviceError) as ei:
                watchdog.guard("unit.stall", lambda: 1, default_s=0.05)
    assert ei.value.site == "unit.stall" and ei.value.deadline_s == 0.05
    assert [e["event"] for e in ev] == ["fault_stall_injected", "watchdog_stall"]
    _join_watchdog_workers("unit.stall")


@pytest.mark.parametrize("recheck", [False, True])
def test_pip_join_planned_stall_raises_and_retries(problem, monkeypatch, recheck):
    """A stall under a short MOSAIC_WATCHDOG_PIP_JOIN_DEVICE deadline
    surfaces as StalledDeviceError, is retried, and the join is still
    bit-identical and undegraded. The abandoned worker is joined before
    the test ends."""
    clean = join(problem, recheck=recheck, cell_dtype=torch.float32)
    monkeypatch.setenv("MOSAIC_WATCHDOG_PIP_JOIN_DEVICE", "0.5")
    try:
        with telemetry.capture() as ev:
            with faults.stalls(1.5, sites=("pip_join.device",)):
                out = join(problem, recheck=recheck, cell_dtype=torch.float32)
    finally:
        _join_watchdog_workers("pip_join.device")
    assert not isinstance(out, DegradedResult)
    np.testing.assert_array_equal(out, clean)
    kinds = [e["event"] for e in ev]
    assert kinds.count("watchdog_stall") == 1
    retry = [e for e in ev if e["event"] == "transient_retry"]
    assert len(retry) == 1 and "StalledDeviceError" in retry[0]["error"]


def test_guarded_call_fallback_degrades():
    def always():
        raise TransientDeviceError("down")

    out = guarded_call("unit.guarded", always,
                       policy=RetryPolicy(max_attempts=2, base_delay_s=0.0),
                       fallback=lambda: np.zeros(3))
    assert isinstance(out, DegradedResult) and out.attempts == 2
    with faults.transient_errors(1, sites=("unit.guarded",)):
        with pytest.raises(TransientDeviceError):
            guarded_call("unit.guarded", lambda: 1, retry=False)


# ------------------------------------------------- spans and telemetry


def test_join_span_carries_the_events(problem):
    with telemetry.capture() as ev:
        with faults.transient_errors(1, sites=("pip_join.device",)):
            join(problem)
    (sp,) = [e for e in ev if e["event"] == "span"]
    assert sp["name"] == "join.pip" and sp["n"] == N_POINTS
    assert sp["recheck"] is False and sp["parent_id"] is None
    retry = [e for e in ev if e["event"] == "transient_retry"]
    assert retry and retry[0]["span_id"] == sp["span_id"]


def test_forced_lane_span(problem, monkeypatch):
    monkeypatch.setenv("MOSAIC_PROBE_FORCE_LANE", "heavy")
    with telemetry.capture() as ev:
        out = join(problem, probe="adaptive")
    np.testing.assert_array_equal(out, problem[3])
    spans = {e["name"]: e for e in ev if e["event"] == "span"}
    assert spans["join.probe.heavy"]["parent_id"] == spans["join.pip"]["span_id"]


def test_span_context_adoption_across_threads():
    seen = {}
    sinks, plans = telemetry.current_sinks(), faults.current_plans()
    with trace.span("root") as sp:
        ctx = trace.current_context()

    def work():
        telemetry.adopt_sinks(sinks)
        faults.adopt_plans(plans)
        trace.adopt_context(ctx)
        with trace.span("child") as c:
            seen["parent"] = c.parent_id
            seen["trace"] = c.context.trace_id

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert seen == {"parent": sp.context.span_id, "trace": sp.context.trace_id}
    assert trace.SpanContext.from_dict(ctx.as_dict()) == ctx


def test_timed_and_summarize():
    with telemetry.capture() as ev:
        with telemetry.timed("stage", k=1):
            time.sleep(0.001)
        with pytest.raises(KeyError):
            with telemetry.timed("stage", k=2):
                raise KeyError("x")
    assert ev[1]["error"] == "KeyError" and ev[0]["seconds"] > 0
    s = telemetry.summarize([{"event": "a", "seconds": v} for v in (4, 1, 3, 2)], "a")
    assert (s["count"], s["p50"], s["max"], s["sum"]) == (4, 2.0, 4.0, 10.0)
    assert telemetry.summarize([], "a")["count"] == 0


def test_nested_capture_detaches_by_identity():
    with telemetry.capture() as outer:
        with telemetry.capture() as inner:
            telemetry.record("x")
        telemetry.record("y")
    assert [e["event"] for e in outer] == ["x", "y"]
    assert [e["event"] for e in inner] == ["x"]
