"""Per-subsystem and per-tenant health: a hysteresis state machine
over the telemetry spine.

Port of ``mosaic_tpu/obs/health.py``, with its event names, scopes,
thresholds and the ``obs.health{scope}`` gauge. :data:`MONITOR` is
installed when ``mosaic_tpu_torch.obs`` is imported; :func:`install` /
:func:`uninstall` stay the explicit switch.

Metrics tell you HOW MUCH (shed count, retry count); the SLO monitor
tells you whether a stated objective is burning. This module answers
the question an operator (and the :class:`~mosaic_tpu_torch.serve.router.
ServeRouter`'s eviction policy) actually asks: *is this subsystem — is
this tenant — OK right now?* One :class:`HealthMonitor` observes the
spine and folds events into per-scope good/bad sliding windows (the
same time-bucketed :class:`~mosaic_tpu_torch.obs.slo.WindowRing` the SLO
monitor uses):

======================  =========================  ====
scope                   good events                bad events
======================  =========================  ====
``serve``               serve_request              serve_shed, router_shed, serve_quarantine, router_evicted
``runtime``             (retries that succeed      transient_retry, retry_exhausted, watchdog_stall, degraded
                        surface as serve/stream
                        goods)
``stream``              stream_stage               capacity_overflow, stream_quarantine
``tenant:<name>``       router_stage stage=admit   router_shed (tenant-labeled)
======================  =========================  ====

Each scope runs the three-state machine **healthy → degrading →
unhealthy** on its windowed bad fraction, with hysteresis: a scope
ENTERS degrading/unhealthy at ``degrading_ratio``/``unhealthy_ratio``
and only CLEARS back down when the ratio falls below ``clear_factor x``
the threshold it entered at — so a tenant flapping around a threshold
does not flap states. Below ``min_events`` in the window the state
holds (three events are noise, not a ratio); an EMPTY window decays to
healthy. Every transition emits one typed ``health_transition`` event
(fields ``scope``, ``prev``, ``to``, ``bad_ratio``) on the spine and
updates the labeled gauge ``obs.health{scope}`` (value = state rank:
0 healthy, 1 degrading, 2 unhealthy) — so fleets scrape per-tenant
health as a first-class series, and trails show exactly when a tenant
went red.

The monitor is ON by default (installed at ``mosaic_tpu_torch.obs``
import): unlike SLO specs, the state machine carries no deployment
policy — transitions are rare single events, and a process that sheds
60% of admissions IS unhealthy no matter the deployment. The :class:`ServeRouter` consumes
:func:`tenant_state` in its eviction order: unhealthy-and-cold engines
go first, so a bounded fleet sheds its sick tenants' residency before
touching a healthy tenant's warm core.
"""

from __future__ import annotations

import threading

from ..runtime import telemetry as _telemetry
from . import metrics as _metrics
from .slo import WindowRing

#: state ranks — the ``obs.health`` gauge value and the router's
#: eviction-order key (higher = sicker = evicted sooner)
RANK = {"healthy": 0, "degrading": 1, "unhealthy": 2}
_STATES = ("healthy", "degrading", "unhealthy")

#: default sliding window (seconds) for the bad-fraction ratio
DEFAULT_WINDOW_S = 60.0

#: enter thresholds: windowed bad fraction at which a scope starts
#: degrading / goes unhealthy
DEFAULT_DEGRADING_RATIO = 0.10
DEFAULT_UNHEALTHY_RATIO = 0.50

#: hysteresis: a scope clears DOWN a state only when its ratio falls
#: below clear_factor x the enter threshold
DEFAULT_CLEAR_FACTOR = 0.5

#: ratio is meaningless over a handful of events — hold state below this
DEFAULT_MIN_EVENTS = 5

#: event -> (scope, is_bad) for subsystem scopes; tenant scoping is
#: handled separately (needs the event's ``tenant`` field)
_SUBSYSTEM_EVENTS = {
    "serve_request": ("serve", False),
    "serve_shed": ("serve", True),
    "serve_quarantine": ("serve", True),
    "router_evicted": ("serve", True),
    "transient_retry": ("runtime", True),
    "retry_exhausted": ("runtime", True),
    "watchdog_stall": ("runtime", True),
    "degraded": ("runtime", True),
    "stream_stage": ("stream", False),
    "capacity_overflow": ("stream", True),
    "stream_quarantine": ("stream", True),
}


class HealthMonitor:
    """The per-scope good/bad windows + state machine. One process-wide
    instance (:data:`MONITOR`) observes the live spine; tests build
    private instances."""

    def __init__(
        self,
        *,
        window_s: float = DEFAULT_WINDOW_S,
        degrading_ratio: float = DEFAULT_DEGRADING_RATIO,
        unhealthy_ratio: float = DEFAULT_UNHEALTHY_RATIO,
        clear_factor: float = DEFAULT_CLEAR_FACTOR,
        min_events: int = DEFAULT_MIN_EVENTS,
    ):
        self.window_s = float(window_s)
        self.degrading_ratio = float(degrading_ratio)
        self.unhealthy_ratio = float(unhealthy_ratio)
        self.clear_factor = float(clear_factor)
        self.min_events = int(min_events)
        self._lock = threading.Lock()
        self._rings: dict[str, WindowRing] = {}
        self._states: dict[str, str] = {}
        self._transitions: dict[str, int] = {}
        # evaluation piggybacks on event arrival at a bounded cadence,
        # like the SLO monitor — the hot path pays a ring add, never a
        # full-scope sweep
        self._eval_interval = max(self.window_s / 8.0, 0.05)
        self._next_eval = float("-inf")
        self._in_eval = False
        subsystem = _SUBSYSTEM_EVENTS
        # hot-path memo: event name -> the scope ring's slot lists +
        # this event's (good, bad) contribution, so the steady state
        # folds one bucket without a lock or a method call (the observer
        # sits on EVERY record(); see the pinned overhead budget in the
        # tests). Lockless is safe under the GIL: every list op is
        # atomic, and the worst interleaving across threads is a
        # bounded undercount at a bucket boundary — immaterial to a
        # windowed hysteresis ratio. State transitions (evaluate) still
        # run under the lock.
        fast = self._fast = {}
        get_fast = fast.get

        def _observe(evt: dict) -> None:
            now = evt.get("ts_mono")
            if now is None:
                return
            ev = evt.get("event")
            hit = get_fast(ev)
            if hit is not None:
                idxs, a_slots, b_slots, width, nslots, good, bad = hit
                i = int(now / width)
                s = i % nslots
                if idxs[s] != i:
                    idxs[s] = i
                    a_slots[s] = 0.0
                    b_slots[s] = 0.0
                a_slots[s] += good
                b_slots[s] += bad
            else:
                route = subsystem.get(ev)
                if route is not None:
                    scope, is_bad = route
                    self._add(scope, now, bad=is_bad)
                    with self._lock:
                        ring = self._rings[scope]
                        fast[ev] = (
                            ring._idx, ring._a, ring._b,
                            ring.width, ring.n,
                            0.0 if is_bad else 1.0,
                            1.0 if is_bad else 0.0,
                        )
                elif ev == "router_shed":
                    # per-tenant bad on top of the serve-scope bad
                    self._add("serve", now, bad=True)
                    tenant = evt.get("tenant")
                    if tenant:
                        self._add(f"tenant:{tenant}", now, bad=True)
                elif ev == "router_stage" and evt.get("stage") == "admit":
                    tenant = evt.get("tenant")
                    if tenant:
                        self._add(f"tenant:{tenant}", now, bad=False)
            if now >= self._next_eval:
                self.evaluate(now)

        self.observer = _observe

    # ------------------------------------------------------- ingestion

    def _add(self, scope: str, now: float, *, bad: bool) -> None:
        with self._lock:
            ring = self._rings.get(scope)
            if ring is None:
                ring = self._rings[scope] = WindowRing(self.window_s)
                self._states[scope] = "healthy"
                self._transitions[scope] = 0
            ring.add(now, 0.0 if bad else 1.0, 1.0 if bad else 0.0)

    # ------------------------------------------------------ evaluation

    def _target(self, cur: str, ratio: float) -> str:
        """Next state under hysteresis: escalate at the enter
        thresholds, clear only below clear_factor x the threshold."""
        if ratio >= self.unhealthy_ratio:
            enter = "unhealthy"
        elif ratio >= self.degrading_ratio:
            enter = "degrading"
        else:
            enter = "healthy"
        if ratio >= self.unhealthy_ratio * self.clear_factor:
            clear = "unhealthy"
        elif ratio >= self.degrading_ratio * self.clear_factor:
            clear = "degrading"
        else:
            clear = "healthy"
        if RANK[enter] > RANK[cur]:
            return enter
        if RANK[clear] < RANK[cur]:
            return clear
        return cur

    def evaluate(self, now: float | None = None) -> dict:
        """Re-evaluate every scope at ``now``; transitions emit
        ``health_transition`` on the spine and update the
        ``obs.health{scope}`` gauge. Returns :meth:`snapshot`'s body."""
        if now is None:
            import time

            now = time.monotonic()
        with self._lock:
            if self._in_eval:
                return {}
            self._in_eval = True
            self._next_eval = now + self._eval_interval
            try:
                snap, emit = self._evaluate_locked(now)
            finally:
                self._in_eval = False
        # emissions re-enter the observer chain — lock released first
        gauge = _metrics.gauge(
            "obs.health",
            "per-scope health rank (0 healthy, 1 degrading, 2 unhealthy)",
        )
        for scope, prev, to, ratio in emit:
            gauge.set(RANK[to], scope=scope)
            _telemetry.record(
                "health_transition",
                scope=scope, prev=prev, to=to, bad_ratio=round(ratio, 6),
            )
        return snap

    def _evaluate_locked(self, now: float):
        snap, emit = {}, []
        for scope, ring in self._rings.items():
            good, bad = ring.totals(now)
            total = good + bad
            cur = self._states[scope]
            if total == 0:
                new = "healthy"  # empty window decays to healthy
                ratio = 0.0
            elif total < self.min_events:
                new = cur  # too few events to trust the ratio
                ratio = bad / total
            else:
                ratio = bad / total
                new = self._target(cur, ratio)
            if new != cur:
                self._states[scope] = new
                self._transitions[scope] += 1
                emit.append((scope, cur, new, ratio))
            snap[scope] = {
                "state": self._states[scope],
                "rank": RANK[self._states[scope]],
                "bad_ratio": round(ratio, 6),
                "events": total,
                "transitions": self._transitions[scope],
            }
        return snap, emit

    # --------------------------------------------------------- queries

    def state(self, scope: str) -> str:
        """Current state of one scope (``"healthy"`` if never seen)."""
        with self._lock:
            return self._states.get(scope, "healthy")

    def tenant_state(self, tenant: str) -> str:
        """Current state of ``tenant:<name>`` — the router's eviction
        input."""
        return self.state(f"tenant:{tenant}")

    def snapshot(self, now: float | None = None) -> dict:
        """One JSON-able dict: per-scope state/ratio/window totals —
        the ops server's ``/health`` body and the doctor's input."""
        return {
            "window_s": self.window_s,
            "scopes": self.evaluate(now),
        }

    def reset(self) -> None:
        """Drop every scope (tests)."""
        with self._lock:
            self._rings.clear()
            self._states.clear()
            self._transitions.clear()
            self._fast.clear()  # memoized rings died with the scopes
            self._next_eval = float("-inf")


#: the process-wide monitor, installed by ``mosaic_tpu_torch.obs.__init__``
MONITOR = HealthMonitor()


def install() -> None:
    """Register :data:`MONITOR` on the spine (idempotent)."""
    _telemetry.add_observer(MONITOR.observer)


def uninstall() -> None:
    _telemetry.remove_observer(MONITOR.observer)


def state(scope: str) -> str:
    """The process monitor's :meth:`HealthMonitor.state`."""
    return MONITOR.state(scope)


def tenant_state(tenant: str) -> str:
    """The process monitor's :meth:`HealthMonitor.tenant_state`."""
    return MONITOR.tenant_state(tenant)


def snapshot(now: float | None = None) -> dict:
    """The process monitor's :meth:`HealthMonitor.snapshot`."""
    return MONITOR.snapshot(now)
