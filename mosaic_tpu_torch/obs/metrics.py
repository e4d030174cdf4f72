"""Typed metrics registry, the gauge part.

Port of the part of ``mosaic_tpu/obs/metrics.py`` that the port's
callers use: :class:`Gauge` (last-write-wins level per label set), the
:class:`Registry` that holds named metrics, the process default
:data:`REGISTRY` with :func:`gauge`, and :func:`snapshot`, one JSON-able
dict of every metric. The stream's ``stream.hbm_peak_bytes{source}`` is
its first user. Counters, histograms, the label-cardinality cap and the
event bridge come with ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Gauge:
    """Last-write-wins level per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())
            ]
        return {"kind": self.kind, "help": self.help, "series": series}


class Registry:
    """Get-or-create home for named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Gauge] = {}

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help)
            return m

    def snapshot(self) -> dict:
        """One JSON-able dict of every metric and series."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}


#: the process default registry the module-level helpers target
REGISTRY = Registry()


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def snapshot() -> dict:
    return REGISTRY.snapshot()
