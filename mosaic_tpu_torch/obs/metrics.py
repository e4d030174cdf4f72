"""Typed metrics registry: counters and gauges with labels.

Port of the part of ``mosaic_tpu/obs/metrics.py`` that the port's
callers use: :class:`Counter` (monotone count per label set; the
dispatch core's ``dispatch.core_cache_evictions`` and the router's
``serve.router_evictions{tenant}``), :class:`Gauge` (last-write-wins
level per label set; ``stream.hbm_peak_bytes{source}``,
``serve.queue_depth``, ``serve.router_resident``, ``obs.health{scope}``),
the :class:`Registry` that holds named metrics (a name registered as one
kind and requested as the other raises ``TypeError``), the process
default :data:`REGISTRY` with :func:`counter` and :func:`gauge`, and
:func:`snapshot`, one JSON-able dict of every metric. Histograms, the
label-cardinality cap and the event bridge come with ROADMAP queue 1
item 13.
"""

from __future__ import annotations

import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            key = _label_key(labels)
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())
            ]
        return {"kind": self.kind, "help": self.help, "series": series}


class Counter(_Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"


class Gauge(_Metric):
    """Last-write-wins level per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(super().value(**labels))


class Registry:
    """Get-or-create home for named metrics; kind conflicts raise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
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

    def snapshot(self) -> dict:
        """One JSON-able dict of every metric and series."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}


#: the process default registry the module-level helpers target
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def snapshot() -> dict:
    return REGISTRY.snapshot()
