"""Observability of the port: tracing, typed metrics, exporters, the
flight recorder, stall attribution, SLOs, health and the ops server,
over the telemetry spine (`runtime/telemetry.py`).

Port of ``mosaic_tpu/obs``, with its public names, event names, metric
names and file formats:

- **tracing** (`obs/trace.py`) — spans with ``trace_id``/``span_id``/
  ``parent_id`` and explicit cross-thread propagation; beyond the
  reference, *stage timing*: while a torch profiler records, after
  ``trace.stage_timing(True)`` or with ``MOSAIC_TRACE_STAGES=1``, spans
  open profiler ranges of their names and the host entry and the stream
  loop record stage spans (``join.pip.{h2d,prepare,cells,counts,probe,
  d2h}``, ``stream.{assign,join,fold_pull}``), the prepare (the device's
  shift and cast), cells and probe stages device-timed with no added
  sync, folded by the bridge into ``trace.stage_device_seconds{stage}``
  and ``trace.stage_points{stage}``.
  Off, a stage boundary costs one flag test and one profiler-state query
  (about 0.13 µs) and emits nothing;
- **metrics** (`obs/metrics.py`) — typed counters/gauges/histograms with
  labels, fed by an event→metric bridge off the spine;
- **exporters** (`obs/export.py`) — JSONL trails, Chrome trace-event JSON,
  Prometheus text exposition;
- **flight recorder** (`obs/recorder.py`) — an always-on bounded ring
  over the spine that auto-dumps on typed failures;
- **timeline attribution** (`obs/timeline.py`) — interval reconstruction
  and the priority sweep that classifies wall time into {transfer,
  compile, queue_wait, host_callback, device, idle};
- **SLO monitor** (`obs/slo.py`) — sliding-window burn-rate evaluation
  (default specs under ``MOSAIC_SLO_ENABLE``);
- **health** (`obs/health.py`) — the per-scope three-state machine the
  serve router's eviction order reads;
- **ops server** (`obs/ops_server.py`) — opt-in (``MOSAIC_OPS_PORT``)
  stdlib-HTTP endpoint serving Prometheus text and the health/SLO
  snapshots.

Tools over trails: ``python -m mosaic_tpu_torch.tools.trace_report``,
``stall_report``, ``perf_gate``, ``fleet_report`` and ``doctor``.

Importing this package registers the tracer, the metric bridge, the
flight recorder, the SLO monitor and the health monitor with the spine,
in that order (and starts the ops server iff ``MOSAIC_OPS_PORT`` is
set); every module that spans work imports it, so the plane is on in
every process that runs a join, a stream or a server.
"""

from . import (
    export,
    health,
    metrics,
    ops_server,
    recorder,
    slo,
    timeline,
    trace,
)
from .export import (
    chrome_trace,
    prometheus_text,
    read_trail,
    trace_summary,
    write_chrome_trace,
    write_jsonl,
)
from .metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    histogram,
    snapshot,
)
from .health import HealthMonitor
from .ops_server import OpsServer
from .recorder import RECORDER, FlightRecorder
from .slo import SLOMonitor, SLOSpec, evaluate_trail
from .trace import (
    Span,
    SpanContext,
    adopt_context,
    current_context,
    span,
    start_span,
)

metrics.install_bridge()
recorder.install()
slo.install()
health.install()
ops_server.maybe_start()

__all__ = [
    "FlightRecorder",
    "HealthMonitor",
    "OpsServer",
    "RECORDER",
    "REGISTRY",
    "SLOMonitor",
    "SLOSpec",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "SpanContext",
    "adopt_context",
    "chrome_trace",
    "counter",
    "current_context",
    "evaluate_trail",
    "export",
    "gauge",
    "health",
    "histogram",
    "metrics",
    "ops_server",
    "prometheus_text",
    "read_trail",
    "recorder",
    "slo",
    "snapshot",
    "span",
    "start_span",
    "timeline",
    "trace",
    "trace_summary",
    "write_chrome_trace",
    "write_jsonl",
]
