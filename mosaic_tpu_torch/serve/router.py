"""Multi-tenant serve router: N resident engines, hard isolation.

Port of ``mosaic_tpu/serve/router.py``. One :class:`ServeEngine` owns one
index and ONE admission queue, so one overloaded caller fills the queue
for everyone behind it. The router gives each tenant its OWN engine (own
bounded queue, own micro-batcher thread, own deadline budget, own
``DispatchCore``), so tenant A's overload cannot occupy a single slot of
tenant B's admission quota — isolation by construction. Shed accounting
is per tenant (``router_shed`` events carry the tenant).

Residency is bounded: at most ``max_resident`` engines (explicit arg >
``MOSAIC_SERVE_TENANTS`` env knob > 4) hold warmed cores at once.
Registering or reviving a tenant past the bound evicts one resident
tenant's engine under the ``router.evict`` fault/watchdog site —
health-aware: unhealthy tenants (`obs/health.py`) lose residency first,
then never-warmed engines, then the least recently used; the evicted
tenant stays registered and is revived on its next submit. A revival
builds nothing: the kernel library is built once per machine and bound
once per process, so its warmup makes zero nvcc builds, and after it
zero cold compiles.

Fault sites: ``router.admit`` (submit path), ``router.evict``,
``router.swap`` — on the runtime's faults/watchdog machinery
(`dispatch.guarded_call` for the two slow ops, `faults.maybe_fail` at
admission).

:meth:`ServeRouter.advance_epoch` publishes an epochal index's newest
epoch (`index/epoch.py`) into one tenant's engine through the
``router.swap`` site; the tenant's metrics carry its ``epoch`` and
``epoch_advances``.

Each tenant may carry a `TuningProfile` (``add_tenant(profile=)``) or
load one from a profile store (``profile_root=``); a corrupt or
mismatched store records ``router_profile_fallback`` and the tenant
serves untuned, as the reference's does.

What differs from the reference: there is no program store
(`dispatch/programs.py`: ``program_store=`` raises), and
``advance_epoch(reprofile=True)`` keeps the engine at the epochal
index's resolution whatever the profile recommends
(`index/epoch.py EpochalIndex.publish`). A tenant whose engine serves
KNN (``add_tenant(..., knn=...)``) takes :meth:`ServeRouter.submit_knn`.
"""

from __future__ import annotations

import os
import threading
import time

from ..dispatch import guarded_call
from ..dispatch.programs import resolve_program_store
from ..obs import health as _health
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..runtime import faults as _faults
from ..runtime import telemetry as _telemetry
from ..runtime.errors import Overloaded
from .engine import ServeEngine

#: resident-engine bound when neither the argument nor the env knob
#: says otherwise; a real fleet sets MOSAIC_SERVE_TENANTS to its memory
#: budget
DEFAULT_MAX_RESIDENT = 4


def resolve_max_resident(max_resident) -> int:
    """Host-side residency-bound resolution: explicit argument >
    ``MOSAIC_SERVE_TENANTS`` env knob > built-in default."""
    if max_resident is not None:
        n = int(max_resident)
    else:
        raw = os.environ.get("MOSAIC_SERVE_TENANTS", "").strip()
        n = int(raw) if raw else DEFAULT_MAX_RESIDENT
    if n < 1:
        raise ValueError(f"max_resident must be >= 1, got {n}")
    return n


class _Tenant:
    """One registered tenant: the config needed to (re)build its
    engine, the live engine when resident, and the router-side
    accounting that survives eviction."""

    __slots__ = (
        "name", "index", "resolution", "profile", "engine_kw",
        "engine", "last_used", "submitted", "shed_admit", "revivals",
        "last_metrics", "epoch", "epoch_advances",
    )

    def __init__(self, name, index, resolution, profile, engine_kw):
        self.name = name
        self.index = index
        self.resolution = resolution
        self.profile = profile
        self.engine_kw = engine_kw
        self.engine: "ServeEngine | None" = None
        self.last_used = 0.0
        self.submitted = 0
        self.shed_admit = 0
        self.revivals = 0
        self.last_metrics: dict = {}
        self.epoch = getattr(index, "epoch", None)
        self.epoch_advances = 0


class ServeRouter:
    """Tenant-keyed front door over per-tenant :class:`ServeEngine`\\ s.

    >>> router = ServeRouter(h3, max_resident=2)
    >>> router.add_tenant("acme", acme_index, 9)
    >>> fut = router.submit("acme", points)
    """

    def __init__(
        self,
        index_system,
        *,
        max_resident: int | None = None,
        program_store=None,
        default_deadline_s: float | None = 1.0,
        queue_capacity: int = 256,
        engine_defaults: dict | None = None,
        health_monitor=None,
    ):
        resolve_program_store(program_store)
        self.index_system = index_system
        self.max_resident = resolve_max_resident(max_resident)
        self.program_store = None
        self.default_deadline_s = default_deadline_s
        self.queue_capacity = queue_capacity
        self.engine_defaults = dict(engine_defaults or {})
        #: the health state machine consulted by the eviction order —
        #: the process monitor unless a test injects its own
        self.health_monitor = (
            _health.MONITOR if health_monitor is None else health_monitor
        )
        self._tenants: dict[str, _Tenant] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._evictions = 0

    # ---------------------------------------------------------- tenants

    def add_tenant(
        self,
        tenant: str,
        index,
        resolution: int,
        *,
        profile=None,
        profile_root: str | None = None,
        deadline_s: float | None = None,
        queue_capacity: int | None = None,
        warm: bool = True,
        **engine_kw,
    ) -> dict:
        """Register ``tenant`` and (by default) bring its engine
        resident and warmed. ``deadline_s`` / ``queue_capacity`` are
        the tenant's deadline budget and admission quota; unset values
        inherit the router defaults. ``profile_root`` loads the
        tenant's newest valid `TuningProfile` bound to this index's
        tessellation — store refusals degrade to serving untuned."""
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        if profile is None and profile_root is not None:
            profile = self._load_profile(tenant, index, profile_root)
        kw = dict(self.engine_defaults)
        kw.update(engine_kw)
        kw.setdefault("queue_capacity", queue_capacity or self.queue_capacity)
        kw.setdefault(
            "default_deadline_s",
            self.default_deadline_s if deadline_s is None else deadline_s,
        )
        t = _Tenant(tenant, index, resolution, profile, kw)
        with self._lock:
            self._tenants[tenant] = t
            stats = self._revive(t) if warm else {}
        _telemetry.record(
            "router_tenant_added", tenant=tenant, warm=warm,
            profiled=profile is not None,
        )
        return stats

    def _load_profile(self, tenant: str, index, profile_root: str):
        from ..tune import (
            ProfileFingerprintMismatch,
            ProfileStore,
            ProfileStoreCorrupt,
            index_fingerprint,
        )

        try:
            profile, _ = ProfileStore(profile_root).load_latest(
                expect_fingerprint=index_fingerprint(index)
            )
            return profile
        except (ProfileStoreCorrupt, ProfileFingerprintMismatch) as e:
            # the store already recorded its typed telemetry; the router
            # adds the tenant-scoped view and serves untuned
            _telemetry.record(
                "router_profile_fallback", tenant=tenant,
                error=repr(e)[:200],
            )
            return None

    def _revive(self, t: _Tenant) -> dict:
        """Build + warm ``t``'s engine (caller holds the lock), evicting
        tenants as needed to respect the residency bound."""
        while self._resident_count() >= self.max_resident:
            victim = self._eviction_victim(exclude=t.name)
            if victim is None:
                break
            self._evict(victim)
        with _trace.span("router.revive", tenant=t.name), _telemetry.timed(
            "router_stage", stage="revive", tenant=t.name
        ):
            t.engine = ServeEngine(
                t.index, self.index_system, t.resolution,
                profile=t.profile, **t.engine_kw,
            )
            stats = t.engine.warmup()
        t.revivals += 1
        t.last_used = time.monotonic()
        _metrics.gauge(
            "serve.router_resident", "resident tenant engines",
        ).set(self._resident_count())
        return stats

    def _resident_count(self) -> int:
        return sum(1 for t in self._tenants.values() if t.engine is not None)

    def _eviction_victim(self, exclude: str) -> "_Tenant | None":
        """Health-aware occupancy-aware LRU: among resident tenants,
        sickest first, then never-warmed engines, then oldest
        ``last_used``."""
        resident = [
            t for t in self._tenants.values()
            if t.engine is not None and t.name != exclude
        ]
        if not resident:
            return None
        rank = _health.RANK
        state = self.health_monitor.tenant_state
        return min(
            resident,
            key=lambda t: (
                -rank[state(t.name)], t.engine.core.warmed, t.last_used,
            ),
        )

    def _evict(self, t: _Tenant) -> None:
        """Close one tenant's engine under the ``router.evict``
        fault/watchdog site (queued requests shed with
        ``reason="shutdown"``); the tenant stays registered."""
        engine = t.engine
        with _trace.span("router.evict", tenant=t.name), _telemetry.timed(
            "router_stage", stage="evict", tenant=t.name
        ):
            # guarded_call's watchdog evaluates the router.evict fault
            # plan on this thread before dispatching
            guarded_call("router.evict", engine.close, retry=False)
        t.last_metrics = engine.metrics()
        t.engine = None
        self._evictions += 1
        _telemetry.record("router_evicted", tenant=t.name)
        _metrics.counter(
            "serve.router_evictions", "tenant engines evicted (LRU)",
        ).inc(tenant=t.name)
        _metrics.gauge(
            "serve.router_resident", "resident tenant engines",
        ).set(self._resident_count())

    def evict(self, tenant: str) -> None:
        """Explicitly release one tenant's engine (it revives on next
        submit)."""
        with self._lock:
            t = self._require(tenant)
            if t.engine is not None:
                self._evict(t)

    # ----------------------------------------------------------- serve

    def submit(self, tenant: str, points, *, deadline_s: float | None = None):
        """Admit one request for ``tenant``; returns its Future.

        Raises the engine's typed :class:`Overloaded` when the TENANT'S
        OWN quota is exhausted. A cold (evicted) tenant is revived first;
        ``router.admit`` is the injectable fault site."""
        if self._closed:
            raise RuntimeError("router is closed")
        with _telemetry.timed("router_stage", stage="admit", tenant=tenant):
            _faults.maybe_fail("router.admit")
            with self._lock:
                t = self._require(tenant)
                if t.engine is None:
                    self._revive(t)
                t.last_used = time.monotonic()
                t.submitted += 1
                engine = t.engine
        try:
            return engine.submit(points, deadline_s=deadline_s)
        except Overloaded as e:
            t.shed_admit += 1
            _telemetry.record("router_shed", tenant=tenant, reason=e.reason)
            raise

    def join(self, tenant, points, *, deadline_s=None, timeout=None):
        """Synchronous convenience wrapper: submit and wait."""
        return self.submit(
            tenant, points, deadline_s=deadline_s
        ).result(timeout)

    def submit_knn(self, tenant: str, points, k: int, *, deadline_s=None):
        """Admit one KNN request for ``tenant`` (its engine built with
        ``knn=``); the quota, revival and shed semantics of :meth:`submit`,
        the future resolves to a batched
        :class:`~mosaic_tpu_torch.knn.KNNAnswer`."""
        if self._closed:
            raise RuntimeError("router is closed")
        with _telemetry.timed(
            "router_stage", stage="admit", tenant=tenant, kind="knn",
        ):
            _faults.maybe_fail("router.admit")
            with self._lock:
                t = self._require(tenant)
                if t.engine is None:
                    self._revive(t)
                t.last_used = time.monotonic()
                t.submitted += 1
                engine = t.engine
        try:
            return engine.submit_knn(points, k, deadline_s=deadline_s)
        except Overloaded as e:
            t.shed_admit += 1
            _telemetry.record("router_shed", tenant=tenant, reason=e.reason)
            raise

    def join_knn(self, tenant, points, k, *, deadline_s=None, timeout=None):
        """Synchronous convenience wrapper: submit_knn and wait."""
        return self.submit_knn(
            tenant, points, k, deadline_s=deadline_s
        ).result(timeout)

    def swap(self, tenant: str, index=None, **hot_swap_kw) -> dict:
        """Hot-swap one tenant's index under the ``router.swap``
        fault/watchdog site — the engine's swap discipline (build aside,
        warm, rebind atomically) applies unchanged, so in-flight requests
        answer from the old snapshot bit for bit."""
        with self._lock:
            t = self._require(tenant)
            if t.engine is None:
                self._revive(t)
            engine = t.engine
        with _trace.span("router.swap", tenant=tenant), _telemetry.timed(
            "router_stage", stage="swap", tenant=tenant
        ):
            stats = guarded_call(
                "router.swap", engine.hot_swap, index,
                retry=False, **hot_swap_kw,
            )
        if index is not None:
            with self._lock:
                t.index = index
        _telemetry.record("router_swapped", tenant=tenant, **stats)
        return stats

    def advance_epoch(
        self, tenant: str, epochal, *, reprofile: bool = False,
        **hot_swap_kw,
    ) -> dict:
        """Publish an :class:`~mosaic_tpu_torch.index.epoch.EpochalIndex`'s
        newest applied epoch into one tenant's engine, through the
        ``router.swap`` guarded site.

        The old-snapshot-keeps-serving contract: the new epoch's core is
        built and warmed ASIDE (``hot_swap``'s discipline) — if the swap
        fails, the guarded site raises, the tenant's engine keeps
        answering from its current snapshot, the tenant's accounting is
        untouched, AND the epochal index stays on its previous published
        epoch (the delta log is already durable, so a later retry
        publishes the same epoch). ``reprofile=True`` re-profiles the
        epoch's column and hands the refreshed profile to the swap, at
        the epochal index's own resolution."""
        with self._lock:
            t = self._require(tenant)
            if t.engine is None:
                self._revive(t)
            engine = t.engine

        class _Guarded:
            """hot_swap proxied through the router's fault site."""

            @staticmethod
            def hot_swap(index, **kw):
                return guarded_call(
                    "router.swap", engine.hot_swap, index,
                    retry=False, **kw,
                )

        stats = epochal.publish(
            _Guarded, reprofile=reprofile, **hot_swap_kw
        )
        with self._lock:
            t.index = epochal.index
            t.epoch = epochal.epoch
            t.epoch_advances += 1
        _telemetry.record(
            "router_epoch_advanced", tenant=tenant,
            epoch=int(epochal.epoch), chips=stats.get("chips", 0),
        )
        return stats

    # ------------------------------------------------------- accounting

    def _require(self, tenant: str) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            raise KeyError(
                f"unknown tenant {tenant!r} — register it with add_tenant"
            )
        return t

    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    def metrics(self) -> dict:
        """Per-tenant engine metrics (live, or last-known for evicted
        tenants) plus the router-level residency story."""
        with self._lock:
            per = {}
            for name, t in self._tenants.items():
                m = (
                    t.engine.metrics()
                    if t.engine is not None
                    else dict(t.last_metrics)
                )
                m.update(
                    resident=t.engine is not None,
                    submitted_router=t.submitted,
                    shed_admit_router=t.shed_admit,
                    revivals=t.revivals,
                    epoch=t.epoch,
                    epoch_advances=t.epoch_advances,
                    health=self.health_monitor.tenant_state(name),
                )
                per[name] = m
            return {
                "tenants": per,
                "registered": len(self._tenants),
                "resident": self._resident_count(),
                "max_resident": self.max_resident,
                "evictions": self._evictions,
            }

    def close(self, timeout: float = 5.0) -> None:
        """Close every resident engine (queued requests shed with
        ``reason="shutdown"``)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for t in self._tenants.values():
                if t.engine is not None:
                    t.last_metrics = t.engine.metrics()
                    t.engine.close(timeout)
                    t.engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
