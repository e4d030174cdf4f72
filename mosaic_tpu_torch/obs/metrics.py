"""Typed metrics registry: counters, gauges, histograms with labels.

Port of ``mosaic_tpu/obs/metrics.py``, with its metric names, labels and
semantics. The flat event trail (`runtime/telemetry.py`) answers "what
happened, in what order"; this registry answers "how much, right now".
Three metric kinds, Prometheus-compatible:

- :class:`Counter` — monotone count (``serve.requests_shed{reason}``,
  ``join.cap_overflows{stage}``, ``obs.compile_count{kind}``);
- :class:`Gauge`   — last-write-wins level (``serve.queue_depth``,
  ``stream.hbm_peak_bytes{source}``);
- :class:`Histogram` — bucketed distribution + sum + count
  (``serve.request_seconds``).

Beyond the reference, the bridge folds every span event that carries
``device_s`` (a device-timed stage, `obs/trace.py stage_span`) into
``trace.stage_device_seconds{stage}`` and ``trace.stage_points{stage}``;
they grow only while stage timing is on.

Recording cost: one ``threading.Lock`` acquire and a dict update per
observation. :func:`snapshot` returns one plain JSON-able dict;
`obs/export.py` renders it as Prometheus text exposition.

The **event bridge** (:func:`install_bridge`, installed when
``mosaic_tpu_torch.obs`` is imported) derives the standard registry from
the telemetry spine itself: the runtime keeps emitting the events it
always emitted, and the bridge folds the well-known ones into metrics,
so the event trail and the metric values never disagree. The compile
counters count the port's own cold path (``serve_compile``: a new
signature after freeze; ``stream_stage`` ``compile``), not nvcc builds,
which ``dispatch.backend_compiles()`` counts.
"""

from __future__ import annotations

import bisect
import threading

from ..runtime import telemetry as _telemetry

#: default latency buckets (seconds): sub-millisecond dispatches through
#: whole-rung warmups of seconds
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: per-metric label-cardinality cap. Labels come from event fields —
#: a tenant name, a shed reason — and one misbehaving caller (tenant
#: ids minted per request) would otherwise grow a series map without
#: bound inside a process-lifetime registry. At the cap, NEW label sets
#: fold into the reserved overflow series below and one typed
#: ``metric_series_overflow`` warning crosses the spine per metric.
DEFAULT_MAX_SERIES = 256

#: the reserved series overflowing label sets fold into —
#: ``{overflow="true"}`` in the snapshot / Prometheus exposition
OVERFLOW_KEY = (("overflow", "true"),)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = ""

    def __init__(
        self, name: str, help: str = "",
        max_series: int = DEFAULT_MAX_SERIES,
    ):
        self.name = name
        self.help = help
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: dict = {}
        self._overflow_warned = False

    def _key(self, labels: dict) -> tuple:
        """The series key for a write, with the cardinality cap applied:
        existing series always resolve to themselves; a NEW label set at
        the cap resolves to :data:`OVERFLOW_KEY`. Caller holds ``_lock``
        and must call :meth:`_warn_overflow` AFTER releasing it."""
        key = _label_key(labels)
        if key in self._series or len(self._series) < self.max_series:
            return key
        return OVERFLOW_KEY

    def _warn_overflow(self, key: tuple) -> None:
        """Emit the one-per-metric typed overflow warning. Called with
        ``_lock`` RELEASED: record() re-enters the observer chain (the
        bridge folds events back into metrics), and a non-reentrant lock
        held across that chain would deadlock on self-referencing
        metrics."""
        if key is OVERFLOW_KEY and not self._overflow_warned:
            self._overflow_warned = True
            _telemetry.record(
                "metric_series_overflow",
                metric=self.name, max_series=self.max_series,
            )

    def labels(self) -> list[dict]:
        """Every label set this metric has recorded under."""
        with self._lock:
            return [dict(k) for k in self._series]

    def _snap_value(self, v):
        return v

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(k), "value": self._snap_value(v)}
                for k, v in sorted(self._series.items())
            ]
        return {"kind": self.kind, "help": self.help, "series": series}


class Counter(_Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0) + n
        self._warn_overflow(key)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-write-wins level per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._series[key] = float(value)
        self._warn_overflow(key)

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + n
        self._warn_overflow(key)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket distribution per label set (Prometheus
    semantics: ``counts[i]`` observations ≤ ``buckets[i]``, plus a
    +Inf overflow bucket, ``sum`` and ``count``)."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
        max_series: int = DEFAULT_MAX_SERIES,
    ):
        super().__init__(name, help, max_series=max_series)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_series(self) -> dict:
        return {
            "counts": [0] * (len(self.buckets) + 1),
            "sum": 0.0,
            "count": 0,
        }

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            key = self._key(labels)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
            s["counts"][i] += 1
            s["sum"] += v
            s["count"] += 1
        self._warn_overflow(key)

    def value(self, **labels) -> dict:
        s = self._series.get(_label_key(labels))
        return dict(s, counts=list(s["counts"])) if s else self._new_series()

    def _snap_value(self, v):
        return {
            "counts": list(v["counts"]),
            "sum": round(v["sum"], 6),
            "count": v["count"],
            "buckets": list(self.buckets),
        }


class Registry:
    """Get-or-create home for named metrics; kind conflicts raise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict:
        """One JSON-able dict of every metric and series — the benches'
        and tests' view, and the Prometheus exporter's input."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def reset(self) -> None:
        """Drop every metric (tests only — production metrics are
        process-lifetime)."""
        with self._lock:
            self._metrics.clear()


#: the process default registry the module-level helpers target
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


# --------------------------------------------------------- event bridge

def _on_event(evt: dict) -> None:
    """Fold one telemetry event into the standard metrics (see module
    docstring). Unknown events cost one dict lookup and pass through."""
    ev = evt.get("event")
    if ev == "capacity_overflow":
        counter("join.cap_overflows").inc(stage=evt.get("stage", ""))
    elif ev == "escalation_resolved":
        counter("join.escalations_resolved").inc(stage=evt.get("stage", ""))
    elif ev == "transient_retry":
        counter("runtime.transient_retries").inc(label=evt.get("label", ""))
    elif ev == "degraded":
        counter("runtime.degraded").inc(label=evt.get("label", ""))
    elif ev == "watchdog_stall":
        counter("runtime.watchdog_stalls").inc(site=evt.get("site", ""))
    elif ev in (
        "fault_injected", "fault_stall_injected", "fault_batch_corrupted",
    ):
        counter("faults.injected").inc(site=evt.get("site", ""))
    elif ev == "serve_shed":
        counter("serve.requests_shed").inc(reason=evt.get("reason", ""))
    elif ev == "router_shed":
        counter("serve.router_shed").inc(
            tenant=evt.get("tenant", ""), reason=evt.get("reason", "")
        )
    elif ev == "slo_violation":
        counter("obs.slo_violations").inc(slo=evt.get("slo", ""))
    elif ev == "serve_request":
        counter("serve.requests_completed").inc()
        if "seconds" in evt:
            histogram("serve.request_seconds").observe(evt["seconds"])
    elif ev == "serve_compile":
        counter("obs.compile_count").inc(kind="serve_cold")
    elif ev in ("serve_quarantine", "stream_quarantine"):
        counter("quarantine.rows").inc(
            evt.get("rows", evt.get("quarantined", 1)) or 0
        )
    elif ev == "snapshot_saved":
        counter("stream.snapshots").inc()
    elif ev == "snapshot_skipped":
        counter("stream.snapshots_skipped").inc()
    elif ev == "stream_stage":
        if evt.get("stage") in ("compile", "gen_compile"):
            counter("obs.compile_count").inc(kind="stream")
        if evt.get("stage") == "join_loop" and "points_per_sec" in evt:
            gauge("stream.points_per_sec").set(evt["points_per_sec"])
    elif ev == "span" and "device_s" in evt:
        # a device-timed stage span (`obs/trace.py stage_span`)
        stage = evt.get("name", "")
        counter("trace.stage_device_seconds").inc(evt["device_s"], stage=stage)
        counter("trace.stage_points").inc(evt.get("points") or 0, stage=stage)


def install_bridge() -> None:
    """Register the event→metric bridge with the telemetry spine
    (idempotent; done automatically when ``mosaic_tpu_torch.obs`` imports)."""
    _telemetry.add_observer(_on_event)


def uninstall_bridge() -> None:
    _telemetry.remove_observer(_on_event)
