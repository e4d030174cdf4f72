"""Opt-in ops pull endpoint: metrics + health + SLO over stdlib HTTP.

Port of ``mosaic_tpu/obs/ops_server.py``, with its routes and bodies.
A fleet scrapes state; it does not read stdout. This module serves the
live ops plane over ``http.server`` (no new dependencies) when
``MOSAIC_OPS_PORT`` is set — OPT-IN, because binding a socket is a
deployment decision the library must never make on import by default:

- ``GET /metrics`` — the registry snapshot as Prometheus text
  exposition (`export.prometheus_text`), scrape-ready;
- ``GET /health``  — :func:`health.snapshot` as JSON (per-scope state
  machine: subsystems and ``tenant:<name>`` scopes);
- ``GET /slo``     — :func:`slo.snapshot` as JSON (per-SLO burn rates
  and breach state);
- ``GET /``        — the combined JSON document, stamped with this
  process's incarnation id (so a fleet poller can tell a restart from
  a metrics reset).

The server is deliberately a SINGLE-threaded ``HTTPServer`` on ONE
daemon serve thread: requests serialize (fine for a scrape every few
seconds), and that one thread adopts the starter's telemetry sinks and
span context (`telemetry.current_sinks`/`adopt_sinks`) — the repo's
standard worker-thread contract, so anything the handler path records
still reaches the installing thread's capture scopes.

``MOSAIC_OPS_PORT=0`` binds an ephemeral port (tests read
:attr:`OpsServer.port` after :meth:`OpsServer.start`).
"""

from __future__ import annotations

import http.server
import json
import os
import threading

from ..runtime import telemetry as _telemetry
from . import export as _export
from . import health as _health
from . import metrics as _metrics
from . import slo as _slo


def combined_snapshot() -> dict:
    """The ``GET /`` body: incarnation + metrics + health + SLO in one
    JSON-able dict (also what `tools/doctor.py` reads when given a live
    endpoint's saved output)."""
    return {
        "incarnation": _telemetry.incarnation(),
        "pid": os.getpid(),
        "metrics": _metrics.snapshot(),
        "health": _health.snapshot(),
        "slo": _slo.snapshot(),
    }


class _Handler(http.server.BaseHTTPRequestHandler):
    # scrape endpoints must not spam stderr with access logs
    def log_message(self, fmt, *args):  # noqa: ARG002
        pass

    def _send(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(
                    _export.prometheus_text().encode(),
                    "text/plain; version=0.0.4",
                )
            elif path == "/health":
                self._send(
                    json.dumps(_health.snapshot()).encode(),
                    "application/json",
                )
            elif path == "/slo":
                self._send(
                    json.dumps(_slo.snapshot()).encode(),
                    "application/json",
                )
            elif path == "/":
                self._send(
                    json.dumps(
                        combined_snapshot(), default=repr
                    ).encode(),
                    "application/json",
                )
            else:
                self.send_error(404)
        except BrokenPipeError:
            pass  # scraper hung up mid-response — its problem


class OpsServer:
    """One bound socket + one daemon serve thread; :meth:`stop` joins."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = http.server.HTTPServer((host, int(port)), _Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The bound port (the real one, after ``port=0``)."""
        return self._httpd.server_address[1]

    def start(self) -> "OpsServer":
        if self._thread is not None:
            return self
        sinks = _telemetry.current_sinks()
        ctx = _telemetry.current_trace()

        def serve():
            # standard worker-thread contract: adopt the starter's
            # sinks and span context so handler-path events land in
            # the installing thread's capture scopes
            _telemetry.adopt_sinks(sinks)
            _telemetry.adopt_trace(ctx)
            self._httpd.serve_forever(poll_interval=0.1)

        self._thread = threading.Thread(  # lint: thread-context-adoption-ok (read-only snapshot server: adopts sinks+trace above; no dispatch runs here, so fault plans never apply)
            target=serve, name="mosaic-ops-server", daemon=True
        )
        self._thread.start()
        _telemetry.record("ops_server_started", port=self.port)
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


#: the env-started process server (None unless MOSAIC_OPS_PORT was set
#: when ``mosaic_tpu_torch.obs`` imported, or :func:`maybe_start` re-ran)
SERVER: OpsServer | None = None


def maybe_start() -> "OpsServer | None":
    """Start the process ops server iff ``MOSAIC_OPS_PORT`` is set to a
    valid port (idempotent; called at ``mosaic_tpu_torch.obs`` import). A bind
    failure (port taken) records ``ops_server_error`` and returns None —
    observability must never take the process down."""
    global SERVER
    if SERVER is not None:
        return SERVER
    raw = os.environ.get("MOSAIC_OPS_PORT", "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    try:
        SERVER = OpsServer(port).start()
    except OSError as e:
        _telemetry.record("ops_server_error", error=repr(e)[:200])
        return None
    return SERVER


def stop() -> None:
    """Stop the env-started server (tests / clean shutdown)."""
    global SERVER
    if SERVER is not None:
        SERVER.stop()
        SERVER = None
