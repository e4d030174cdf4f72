"""Flight recorder: an always-on bounded ring over the telemetry spine.

Port of ``mosaic_tpu/obs/recorder.py``, with its triggers, knobs and dump
format (a JSONL trail either package's ``read_trail`` reads).

Bench trails are opt-in: when a production run dies with a
``RetryExhausted`` at 3am, nobody was capturing, and the evidence is
gone — diagnosis requires a re-run. The flight recorder closes that
gap: a process-wide ``collections.deque(maxlen=N)`` registered as a
telemetry *observer* (the same hook the metrics bridge uses) keeps the
last N events always, and *auto-dumps* the ring the moment a typed
failure event crosses the spine:

- ``retry_exhausted``  → :class:`~..runtime.errors.RetryExhausted`
- ``watchdog_stall``   → :class:`~..runtime.errors.StalledDeviceError`
- ``degraded``         → :class:`~..runtime.errors.DegradedResult`

The dump is a frozen in-memory snapshot (:attr:`FlightRecorder.
last_dump`) and, when ``MOSAIC_RECORDER_DIR`` is set, a JSONL trail
file ready for `tools/stall_report.py` / `tools/trace_report.py`.

Cost contract: the observer is one deque append plus one frozenset
membership test per event — the pinned microbenchmark
(`tests/test_torch_recorder.py`) holds installed ``record()`` to ≤ 1.15× the
bare path. ``MOSAIC_RECORDER_N`` sizes the ring (default 4096; ``0``
disables recording entirely).

Deque appends are GIL-atomic, so concurrent recorders (serve submit
threads, the batcher, watchdog workers) never corrupt the ring;
``maxlen`` gives O(1) eviction with a hard memory bound.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from ..runtime import telemetry as _telemetry

#: ring capacity when ``MOSAIC_RECORDER_N`` is unset
DEFAULT_N = 4096

#: events that auto-dump the ring — the telemetry names of the three
#: typed failures (RetryExhausted / StalledDeviceError / DegradedResult)
#: plus SLO burn-rate breaches (`obs/slo.py` emits ``slo_violation`` on
#: the spine precisely so it rides this trigger like any typed failure)
TRIGGER_EVENTS = frozenset({
    "retry_exhausted", "watchdog_stall", "degraded", "slo_violation",
})

#: floor between auto-dump *file writes* — a systemic failure degrades
#: every segment; one trail per storm, not one per event
MIN_DUMP_INTERVAL_S = 0.25


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class FlightRecorder:
    """The bounded ring + auto-dump policy. One process-wide instance
    (:data:`RECORDER`) is installed at ``mosaic_tpu_torch.obs`` import; tests
    build private instances to probe the policy in isolation."""

    def __init__(
        self,
        maxlen: int | None = None,
        *,
        triggers=TRIGGER_EVENTS,
        min_dump_interval_s: float = MIN_DUMP_INTERVAL_S,
    ):
        if maxlen is None:
            maxlen = _env_int("MOSAIC_RECORDER_N", DEFAULT_N)
        self.maxlen = max(int(maxlen), 0)
        self.enabled = self.maxlen > 0
        self._ring: collections.deque = collections.deque(
            maxlen=self.maxlen or 1
        )
        self.triggers = frozenset(triggers)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.auto_dumps = 0
        self.last_dump: list | None = None
        self.last_dump_path: str | None = None
        self._last_file_t = float("-inf")
        self._dump_lock = threading.Lock()
        self._in_dump = False
        # the observer the spine actually calls: everything pre-bound
        # into locals so the per-event cost is one function call, one
        # deque append, one dict getitem, one frozenset test — the
        # pinned ≤1.15x budget leaves no room for attribute lookups
        append = self._ring.append
        triggers = self.triggers
        auto_dump = self._auto_dump

        def _observe(evt: dict) -> None:
            append(evt)
            if evt["event"] in triggers:
                auto_dump(evt)

        self.observer = _observe

    # ------------------------------------------------- observer hot path

    def __call__(self, evt: dict) -> None:
        """The telemetry observer: one append, one membership test."""
        if not self.enabled:
            return
        self.observer(evt)

    # ---------------------------------------------------------- queries

    def events(self) -> list[dict]:
        """A snapshot copy of the ring, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.last_dump = None
        self.last_dump_path = None
        self._last_file_t = float("-inf")

    # ------------------------------------------------------------ dumps

    def dump(self, path: str | None = None) -> list[dict]:
        """Snapshot the ring on demand; write it as a JSONL trail when
        ``path`` is given. Returns the snapshot."""
        snap = self.events()
        if path:
            _write_jsonl(snap, path)
        return snap

    def _auto_dump(self, evt: dict) -> None:
        with self._dump_lock:
            if self._in_dump:
                # re-entrant trigger (the recorder_dump event, or a
                # trigger recorded by a dump hook) — already dumping
                return
            self._in_dump = True
        try:
            snap = self.events()
            self.last_dump = snap
            self.auto_dumps += 1
            path = None
            out_dir = os.environ.get("MOSAIC_RECORDER_DIR")
            now = time.monotonic()
            if out_dir and (
                now - self._last_file_t >= self.min_dump_interval_s
            ):
                self._last_file_t = now
                name = f"flight-{evt.get('seq', 0):010d}-{evt['event']}"
                if evt.get("slo") is not None:
                    # slo_violation dumps name the violated SLO and its
                    # evaluation window, so a directory of dumps reads
                    # as an incident log without opening any file
                    name += (
                        f"-{_safe(evt['slo'])}"
                        f"-w{evt.get('window_s', 0):g}s"
                    )
                path = os.path.join(out_dir, name + ".jsonl")
                try:
                    os.makedirs(out_dir, exist_ok=True)
                    _write_jsonl(snap, path)
                    self.last_dump_path = path
                except OSError:
                    path = None
            extra = (
                {"slo": evt["slo"], "window_s": evt.get("window_s")}
                if evt.get("slo") is not None else {}
            )
            _telemetry.record(
                "recorder_dump",
                trigger=evt["event"],
                trigger_seq=evt.get("seq"),
                n_events=len(snap),
                path=path,
                **extra,
            )
        finally:
            self._in_dump = False


def _safe(name) -> str:
    """Filesystem-safe fragment of an SLO name for dump filenames."""
    return "".join(
        c if (c.isalnum() or c in "._-") else "_" for c in str(name)
    )


def _write_jsonl(events, path: str) -> None:
    # local writer, not export.write_jsonl: the recorder must stay
    # importable below the exporters (no circular obs-internal deps).
    # Same header contract though: an incarnation meta line first, so
    # fleet_report can stitch recorder dumps next to bench trails.
    with open(path, "w") as f:
        f.write(json.dumps(_telemetry.incarnation_event()) + "\n")
        for e in events:
            f.write(json.dumps(e, default=repr) + "\n")


#: the process-wide recorder, installed by ``mosaic_tpu_torch.obs.__init__``
RECORDER = FlightRecorder()


def install() -> None:
    """Register :data:`RECORDER` on the telemetry spine (idempotent;
    a no-op when ``MOSAIC_RECORDER_N=0`` disabled the ring)."""
    if RECORDER.enabled:
        _telemetry.add_observer(RECORDER.observer)


def uninstall() -> None:
    """Unregister :data:`RECORDER` (idempotent)."""
    _telemetry.remove_observer(RECORDER.observer)


def dump(path: str | None = None) -> list[dict]:
    """Snapshot the process recorder (see :meth:`FlightRecorder.dump`)."""
    return RECORDER.dump(path)


def events() -> list[dict]:
    """The process recorder's current ring, oldest first."""
    return RECORDER.events()
