"""SLO registry + multi-window burn-rate monitor over the telemetry spine.

Port of ``mosaic_tpu/obs/slo.py``, with its specs, knobs, event names and
verdicts.
The flight recorder explains a failure after it happened; this module
says a failure is HAPPENING. An :class:`SLOMonitor` registers as a
telemetry observer (the same ``add_observer`` hook the metrics bridge
and recorder use — the runtime never imports it) and folds the spine's
events into monotonic-clock sliding windows:

- **ratio SLOs** — each matching event is classified good or bad
  (admitted request under the latency threshold, vs. a typed shed or a
  degradation) into a time-bucketed ring (:class:`WindowRing`) covering
  the long window;
- **latency** additionally keeps a ring-buffered windowed HISTOGRAM
  (:class:`WindowHistogram`) so the snapshot can report the live
  windowed p99, not just the over/under fraction;
- **rate SLOs** — a windowed mean of a gauge-like event field
  (sustained stream points/sec);
- **count SLOs** — a zero-budget event count (cold compiles after
  warmup: ANY occurrence in the window is a breach).

**Burn rate.** For a ratio SLO with objective ``o`` the error budget is
``1 - o``; the burn rate over a window is ``bad_fraction / (1 - o)``
(1.0 = consuming budget exactly as fast as the objective allows). A
breach requires the burn rate to exceed ``burn_threshold`` over BOTH
the short and the long window — the classic multi-window rule: the
short window makes the alert fast, the long window keeps a blip from
paging. On the healthy→breached transition the monitor emits ONE typed
``slo_violation`` event **on the spine itself** via ``telemetry.record``
— so it is stamped with the active trace like any event, the metrics
bridge counts it (``obs.slo_violations{slo}``), and the flight recorder
auto-dumps (``slo_violation`` is a trigger event, dump named after the
SLO and window). Hysteresis: the SLO re-arms only after the short-window
burn falls below ``clear_factor x threshold``.

The process-wide :data:`MONITOR` installs its observer at
``mosaic_tpu_torch.obs`` import, but registers the DEFAULT SPECS (admitted
latency, typed-shed fraction, degraded fraction, cold compiles after
freeze, sustained stream rate) only when ``MOSAIC_SLO_ENABLE`` is set:
alerting thresholds are deployment policy, and the repo's own overload
benches shed on purpose. Knobs (all read at enable time):

- ``MOSAIC_SLO_ENABLE``        — truthy: register the default specs;
- ``MOSAIC_SLO_WINDOW_S``      — short window seconds (default 60; the
  long window is 5x the short);
- ``MOSAIC_SLO_BURN``          — burn-rate breach threshold (default 1.0);
- ``MOSAIC_SLO_LATENCY_S``     — admitted-latency threshold (default 1.0);
- ``MOSAIC_SLO_SHED_MAX``      — typed-shed budget fraction (default 0.05);
- ``MOSAIC_SLO_DEGRADED_MAX``  — degraded budget fraction (default 0.05);
- ``MOSAIC_SLO_STREAM_RATE_MIN`` — sustained stream points/sec floor
  (default 0 = that SLO disabled).

Benches evaluate the same specs post-hoc over a captured trail with
:func:`evaluate_trail` (the ``--slo`` lane of serve_bench/stream_bench).
"""

from __future__ import annotations

import dataclasses
import os
import threading

from ..runtime import telemetry as _telemetry
from . import metrics as _metrics

#: default short evaluation window (seconds) when MOSAIC_SLO_WINDOW_S
#: is unset; the long window is LONG_FACTOR x the short window
DEFAULT_WINDOW_S = 60.0
LONG_FACTOR = 5.0

#: default burn-rate breach threshold (1.0 = consuming the error budget
#: exactly at the objective's allowed rate)
DEFAULT_BURN_THRESHOLD = 1.0

#: short-window burn must fall below clear_factor x threshold before a
#: breached SLO re-arms — one violation event per breach EPISODE
DEFAULT_CLEAR_FACTOR = 0.5

#: ratio/rate SLOs stay silent below this many window events — three
#: requests, one shed is startup noise, not a 33% error rate
DEFAULT_MIN_EVENTS = 10

_TRUTHY = ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class WindowRing:
    """Monotonic-clock sliding window over two accumulators (``a``/``b``
    — good/bad counts for ratio SLOs, value-sum/sample-count for rate
    SLOs), time-bucketed so memory is O(buckets) regardless of event
    rate. Resolution is ``window_s / n_buckets``; totals are exact at
    bucket granularity, which is all a burn-rate evaluation needs."""

    __slots__ = ("window_s", "width", "n", "_a", "_b", "_idx")

    def __init__(self, window_s: float, n_buckets: int = 64):
        self.window_s = float(window_s)
        self.n = int(n_buckets)
        self.width = self.window_s / self.n
        self._a = [0.0] * self.n
        self._b = [0.0] * self.n
        self._idx = [-1] * self.n  # absolute bucket index, -1 = empty

    def add(self, now: float, a: float = 0.0, b: float = 0.0) -> None:
        idx = int(now / self.width)
        slot = idx % self.n
        if self._idx[slot] != idx:
            self._idx[slot] = idx
            self._a[slot] = 0.0
            self._b[slot] = 0.0
        self._a[slot] += a
        self._b[slot] += b

    def totals(
        self, now: float, window_s: float | None = None
    ) -> tuple[float, float]:
        """``(sum_a, sum_b)`` over buckets within ``window_s`` of
        ``now`` (default: the full ring window)."""
        w = self.window_s if window_s is None else min(
            float(window_s), self.window_s
        )
        lo = int((now - w) / self.width)
        hi = int(now / self.width)
        ta = tb = 0.0
        for slot in range(self.n):
            idx = self._idx[slot]
            if lo < idx <= hi or idx == lo == hi:
                ta += self._a[slot]
                tb += self._b[slot]
        return ta, tb

    def reset(self) -> None:
        for slot in range(self.n):
            self._idx[slot] = -1
            self._a[slot] = 0.0
            self._b[slot] = 0.0


class WindowHistogram:
    """Ring-buffered windowed histogram: per time bucket, one value-
    bucket count vector (`metrics.DEFAULT_BUCKETS` edges + overflow).
    Answers "what is the p99 over the last W seconds" to value-bucket
    resolution — the live twin of the cumulative
    :class:`~mosaic_tpu_torch.obs.metrics.Histogram`."""

    __slots__ = ("window_s", "width", "n", "edges", "_counts", "_idx")

    def __init__(
        self, window_s: float, n_buckets: int = 64,
        edges=_metrics.DEFAULT_BUCKETS,
    ):
        self.window_s = float(window_s)
        self.n = int(n_buckets)
        self.width = self.window_s / self.n
        self.edges = tuple(float(e) for e in edges)
        self._counts = [None] * self.n  # lazy per-slot count vectors
        self._idx = [-1] * self.n

    def observe(self, now: float, value: float) -> None:
        import bisect

        idx = int(now / self.width)
        slot = idx % self.n
        if self._idx[slot] != idx or self._counts[slot] is None:
            self._idx[slot] = idx
            self._counts[slot] = [0] * (len(self.edges) + 1)
        self._counts[slot][bisect.bisect_left(self.edges, value)] += 1

    def percentile(
        self, now: float, q: float, window_s: float | None = None
    ) -> float | None:
        """The q-th percentile value-bucket upper edge over the window
        (None with no samples; +Inf bucket reports the last edge)."""
        w = self.window_s if window_s is None else min(
            float(window_s), self.window_s
        )
        lo = int((now - w) / self.width)
        hi = int(now / self.width)
        merged = [0] * (len(self.edges) + 1)
        for slot in range(self.n):
            idx = self._idx[slot]
            if (lo < idx <= hi or idx == lo == hi) and self._counts[slot]:
                for i, c in enumerate(self._counts[slot]):
                    merged[i] += c
        total = sum(merged)
        if not total:
            return None
        target = q * total
        cum = 0
        for i, c in enumerate(merged):
            cum += c
            if cum >= target:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective.

    ``kind``:
    - ``"ratio"``  — ``objective`` is the required good fraction; the
      monitor wires good/bad event classifiers at registration;
    - ``"rate_min"`` — ``rate_min`` is the required windowed mean of an
      event field; ``objective`` is unused;
    - ``"count_zero"`` — zero-budget event count: any bad event in the
      short window is a breach (``objective`` unused).
    """

    name: str
    kind: str = "ratio"
    objective: float = 0.99
    description: str = ""
    threshold_s: float | None = None  # latency SLOs: the good/bad cut
    rate_min: float | None = None
    min_events: int = DEFAULT_MIN_EVENTS


class SLOMonitor:
    """The spec registry + sliding-window aggregator + burn-rate
    evaluator. One process-wide instance (:data:`MONITOR`) observes the
    live spine; benches build private instances to replay trails."""

    def __init__(
        self,
        *,
        short_window_s: float | None = None,
        long_window_s: float | None = None,
        burn_threshold: float | None = None,
        clear_factor: float = DEFAULT_CLEAR_FACTOR,
    ):
        if short_window_s is None:
            short_window_s = _env_float(
                "MOSAIC_SLO_WINDOW_S", DEFAULT_WINDOW_S
            )
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(
            long_window_s
            if long_window_s is not None
            else self.short_window_s * LONG_FACTOR
        )
        if burn_threshold is None:
            burn_threshold = _env_float(
                "MOSAIC_SLO_BURN", DEFAULT_BURN_THRESHOLD
            )
        self.burn_threshold = float(burn_threshold)
        self.clear_factor = float(clear_factor)
        self._lock = threading.Lock()
        self._specs: dict[str, SLOSpec] = {}
        self._rings: dict[str, WindowRing] = {}
        self._hists: dict[str, WindowHistogram] = {}
        self._breached: dict[str, bool] = {}
        self._violations: dict[str, int] = {}
        #: event name -> [(slo_name, classify(evt) -> (a, b) | None)]
        self._handlers: dict[str, list] = {}
        # evaluation piggybacks on event arrival at a bounded cadence
        self._eval_interval = max(self.short_window_s / 8.0, 0.05)
        self._next_eval = float("-inf")
        self._in_eval = False
        # the observer the spine calls: locals pre-bound, unknown
        # events cost ONE dict lookup (the hot-path budget)
        handlers = self._handlers

        def _observe(evt: dict) -> None:
            hs = handlers.get(evt.get("event"))
            now = evt.get("ts_mono")
            if hs is not None and now is not None:
                self._ingest(hs, evt, now)
            if now is not None and now >= self._next_eval:
                self.evaluate(now)

        self.observer = _observe

    # ---------------------------------------------------- registration

    def register(self, spec: SLOSpec) -> SLOSpec:
        """Register a spec (rings sized to this monitor's windows);
        wire events to it with the ``wire_*`` helpers."""
        with self._lock:
            self._specs[spec.name] = spec
            self._rings[spec.name] = WindowRing(self.long_window_s)
            self._breached[spec.name] = False
            self._violations[spec.name] = 0
            if spec.kind == "ratio" and spec.threshold_s is not None:
                self._hists[spec.name] = WindowHistogram(
                    self.long_window_s
                )
        return spec

    def _wire(self, event: str, slo_name: str, classify) -> None:
        with self._lock:
            self._handlers.setdefault(event, []).append(
                (slo_name, classify)
            )

    def wire_good(self, spec: SLOSpec, *events: str, stage=None) -> None:
        """Count each matching event as one GOOD unit."""
        for ev in events:
            if stage is None:
                self._wire(ev, spec.name, lambda evt: (1.0, 0.0))
            else:
                self._wire(
                    ev, spec.name,
                    lambda evt, s=stage: (
                        (1.0, 0.0) if evt.get("stage") == s else None
                    ),
                )

    def wire_bad(self, spec: SLOSpec, *events: str) -> None:
        """Count each matching event as one BAD unit."""
        for ev in events:
            self._wire(ev, spec.name, lambda evt: (0.0, 1.0))

    def wire_latency(
        self, spec: SLOSpec, event: str, field: str = "seconds"
    ) -> None:
        """Classify each event good/bad against ``spec.threshold_s``
        and feed the windowed histogram."""
        thresh = float(spec.threshold_s)
        hist = self._hists.get(spec.name)

        def classify(evt, _t=thresh, _h=hist):
            v = evt.get(field)
            if not isinstance(v, (int, float)):
                return None
            if _h is not None:
                _h.observe(evt.get("ts_mono", 0.0), float(v))
            return (1.0, 0.0) if v <= _t else (0.0, 1.0)

        self._wire(event, spec.name, classify)

    def wire_rate(
        self, spec: SLOSpec, event: str, field: str,
        stage: str | None = None,
    ) -> None:
        """Feed a gauge-like event field into the rate ring (value sum
        in ``a``, sample count in ``b``; windowed mean = a/b)."""

        def classify(evt, _f=field, _s=stage):
            if _s is not None and evt.get("stage") != _s:
                return None
            v = evt.get(_f)
            if not isinstance(v, (int, float)):
                return None
            return (float(v), 1.0)

        self._wire(event, spec.name, classify)

    # ------------------------------------------------------- ingestion

    def _ingest(self, handlers, evt: dict, now: float) -> None:
        with self._lock:
            for slo_name, classify in handlers:
                ab = classify(evt)
                if ab is None:
                    continue
                ring = self._rings.get(slo_name)
                if ring is not None:
                    ring.add(now, ab[0], ab[1])

    # ------------------------------------------------------ evaluation

    def _burn(self, spec: SLOSpec, ring, now, window_s):
        """(burn_rate, detail) over one window, or (None, ...) with
        insufficient data."""
        a, b = ring.totals(now, window_s)
        total = a + b
        if spec.kind == "count_zero":
            return (float(b) if b else 0.0), {"bad": b}
        if spec.kind == "rate_min":
            if b < 1 or (a / b) <= 0:
                return None, {"samples": b}
            mean = a / b
            floor = float(spec.rate_min or 0.0)
            if floor <= 0:
                return 0.0, {"mean": mean}
            return floor / mean, {"mean": round(mean, 3)}
        # ratio
        if total < spec.min_events:
            return None, {"events": total}
        bad_frac = b / total
        budget = max(1.0 - float(spec.objective), 1e-9)
        return bad_frac / budget, {
            "bad_fraction": round(bad_frac, 6), "events": total,
        }

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Evaluate every registered SLO at ``now`` (monotonic seconds);
        healthy→breached transitions emit ``slo_violation`` on the
        spine. Returns the per-SLO status list (also the snapshot's
        ``slos`` content)."""
        if now is None:
            import time

            now = time.monotonic()
        with self._lock:
            if self._in_eval:
                return []
            self._in_eval = True
            self._next_eval = now + self._eval_interval
            try:
                statuses, emit = self._evaluate_locked(now)
            finally:
                self._in_eval = False
        # record() OUTSIDE the lock: the violation re-enters the
        # observer chain (recorder dump, metrics bridge, this monitor)
        for fields in emit:
            _telemetry.record("slo_violation", **fields)
        return statuses

    def _evaluate_locked(self, now: float):
        statuses, emit = [], []
        for name, spec in self._specs.items():
            ring = self._rings[name]
            burn_s, det_s = self._burn(
                spec, ring, now, self.short_window_s
            )
            burn_l, det_l = self._burn(
                spec, ring, now, self.long_window_s
            )
            breaching = (
                burn_s is not None and burn_l is not None
                and burn_s >= self.burn_threshold
                and burn_l >= self.burn_threshold
            )
            was = self._breached[name]
            if breaching and not was:
                self._breached[name] = True
                self._violations[name] += 1
                emit.append(dict(
                    slo=name,
                    kind=spec.kind,
                    objective=spec.objective,
                    burn_rate=round(burn_s, 4),
                    burn_rate_long=round(burn_l, 4),
                    window_s=self.short_window_s,
                    long_window_s=self.long_window_s,
                    **det_s,
                ))
            elif was and (
                burn_s is None
                or burn_s < self.burn_threshold * self.clear_factor
            ):
                self._breached[name] = False
            status = {
                "slo": name,
                "kind": spec.kind,
                "objective": spec.objective,
                "breached": self._breached[name],
                "violations": self._violations[name],
                "burn_short": (
                    round(burn_s, 4) if burn_s is not None else None
                ),
                "burn_long": (
                    round(burn_l, 4) if burn_l is not None else None
                ),
                "detail": det_s,
            }
            hist = self._hists.get(name)
            if hist is not None:
                p99 = hist.percentile(now, 0.99, self.short_window_s)
                status["p99_s"] = p99
            statuses.append(status)
        return statuses, emit

    # --------------------------------------------------------- queries

    def snapshot(self, now: float | None = None) -> dict:
        """One JSON-able dict: windows, threshold, and per-SLO status —
        the ops server's ``/slo`` body and the doctor's input."""
        statuses = self.evaluate(now)
        return {
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "burn_threshold": self.burn_threshold,
            "slos": {s["slo"]: s for s in statuses},
        }

    def specs(self) -> list[SLOSpec]:
        with self._lock:
            return list(self._specs.values())

    def reset(self) -> None:
        """Drop all windowed state and re-arm every SLO (tests)."""
        with self._lock:
            for ring in self._rings.values():
                ring.reset()
            for name in self._breached:
                self._breached[name] = False
                self._violations[name] = 0
            self._next_eval = float("-inf")


def register_default_specs(monitor: SLOMonitor) -> list[SLOSpec]:
    """The standard SLO set, thresholds from the ``MOSAIC_SLO_*`` env
    knobs (read here, at enable time — not at import)."""
    latency = monitor.register(SLOSpec(
        name="serve.latency",
        kind="ratio",
        objective=0.99,
        threshold_s=_env_float("MOSAIC_SLO_LATENCY_S", 1.0),
        description="admitted-request latency: p99 under threshold "
                    "(good fraction >= 0.99)",
    ))
    monitor.wire_latency(latency, "serve_request")

    shed_max = _env_float("MOSAIC_SLO_SHED_MAX", 0.05)
    shed = monitor.register(SLOSpec(
        name="serve.shed",
        kind="ratio",
        objective=1.0 - shed_max,
        description="typed-shed fraction of admission decisions",
    ))
    monitor.wire_good(shed, "serve_request")
    monitor.wire_bad(shed, "serve_shed", "router_shed")

    degraded_max = _env_float("MOSAIC_SLO_DEGRADED_MAX", 0.05)
    degraded = monitor.register(SLOSpec(
        name="runtime.degraded",
        kind="ratio",
        objective=1.0 - degraded_max,
        description="degraded-result fraction of completed requests",
    ))
    monitor.wire_good(degraded, "serve_request")
    monitor.wire_bad(degraded, "degraded")

    cold = monitor.register(SLOSpec(
        name="serve.cold_compile",
        kind="count_zero",
        description="cold compiles after freeze: any serve_compile "
                    "in the window is a breach",
    ))
    monitor.wire_bad(cold, "serve_compile")

    specs = [latency, shed, degraded, cold]
    rate_min = _env_float("MOSAIC_SLO_STREAM_RATE_MIN", 0.0)
    if rate_min > 0:
        stream = monitor.register(SLOSpec(
            name="stream.sustained_rate",
            kind="rate_min",
            rate_min=rate_min,
            min_events=1,
            description="windowed mean stream join rate (points/sec) "
                        "above the floor",
        ))
        monitor.wire_rate(
            stream, "stream_stage", "points_per_sec", stage="join_loop"
        )
        specs.append(stream)
    return specs


#: the process-wide monitor; its observer is installed at
#: ``mosaic_tpu_torch.obs`` import, its default specs only under
#: ``MOSAIC_SLO_ENABLE`` (see module docstring)
MONITOR = SLOMonitor()


def install() -> None:
    """Register :data:`MONITOR` on the spine (idempotent); register the
    default specs when ``MOSAIC_SLO_ENABLE`` is truthy."""
    _telemetry.add_observer(MONITOR.observer)
    enable = os.environ.get("MOSAIC_SLO_ENABLE", "").strip().lower()
    if enable in _TRUTHY and not MONITOR.specs():
        register_default_specs(MONITOR)


def uninstall() -> None:
    _telemetry.remove_observer(MONITOR.observer)


def snapshot(now: float | None = None) -> dict:
    """The process monitor's :meth:`SLOMonitor.snapshot`."""
    return MONITOR.snapshot(now)


def evaluate_trail(events, *, specs: str = "default") -> dict:
    """Replay a captured trail through a FRESH monitor and evaluate the
    registered SLOs over the whole run — the benches' ``--slo`` lane.

    Windows are sized to the trail's monotonic span (short = span, long
    = span), so the verdict covers the entire run; breach transitions
    during replay emit real ``slo_violation`` events on the spine (they
    land in the caller's still-open capture, and trip the recorder).
    Returns ``{"verdicts": {...}, "breached": [names], "ok": bool}``.
    """
    stamps = [
        e["ts_mono"] for e in events
        if isinstance(e, dict) and isinstance(
            e.get("ts_mono"), (int, float)
        )
    ]
    span = (max(stamps) - min(stamps)) if stamps else 1.0
    span = max(span, 1e-3)
    m = SLOMonitor(
        short_window_s=span * 1.001, long_window_s=span * 1.001
    )
    # disable cadence-driven mid-replay evaluation: one verdict over
    # the full run, then exactly one violation event per breached SLO
    m._next_eval = float("inf")
    if specs == "default":
        register_default_specs(m)
    for e in list(events):
        if not isinstance(e, dict):
            continue
        hs = m._handlers.get(e.get("event"))
        now = e.get("ts_mono")
        if hs is not None and now is not None:
            m._ingest(hs, e, now)
    statuses = m.evaluate(max(stamps) if stamps else 0.0)
    verdicts = {s["slo"]: s for s in statuses}
    breached = sorted(n for n, s in verdicts.items() if s["breached"])
    return {
        "verdicts": verdicts,
        "breached": breached,
        "ok": not breached,
        "window_s": round(span, 3),
    }
