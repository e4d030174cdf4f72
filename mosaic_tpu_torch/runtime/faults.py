"""Fault injection: force the failure modes the resilience layer handles.

Port of ``mosaic_tpu/runtime/faults.py``. Context managers install a
thread-local fault plan that the instrumented device entry points
consult (the port's `pip_join`, through the dispatch core's
``guarded_call("pip_join.device", ...)``):

- :func:`shrink_caps` clamps the exactly-sized compaction caps down, so
  the next join genuinely overflows tier 1/2 and must escalate back to
  exactness (:func:`force_tier2_overflow` is the tier-2 spelling);
- :func:`transient_errors` raises a synthetic
  :class:`TransientDeviceError` (or ``exc_factory``'s exception) on the
  first N guarded calls;
- :func:`stalls` plans a simulated hang (seconds of dead time) inside
  the next N watchdog-guarded calls, so `runtime/watchdog.py` deadlines
  are exercised for real;
- :func:`corrupt_batches` poisons the first rows of batches passing
  through :func:`maybe_corrupt` (NaN coordinates by default);
- :func:`inject` composes all of them; ``skip_first`` delays any of the
  synthetic failures past the first N matching calls.

With no plan installed every hook is a near-free no-op (one thread-local
attribute read), so production paths pay nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading

import numpy as np

from . import telemetry
from .errors import TransientDeviceError

_LOCAL = threading.local()


@dataclasses.dataclass
class FaultPlan:
    """One active injection: cap clamps + synthetic transient failures +
    simulated stalls + batch corruption."""

    cap_clamps: dict[str, int] = dataclasses.field(default_factory=dict)
    fail_first: int = 0
    sites: tuple[str, ...] = ("*",)
    exc_factory: "Callable[[str], BaseException] | None" = None
    #: matching maybe_fail calls to let through before failing starts
    skip_first: int = 0
    #: simulated hang: seconds of dead time in the first N guarded calls
    stall_s: float = 0.0
    stall_first: int = 0
    #: batch poison: overwrite the first N rows of each batch with value
    corrupt_rows: int = 0
    corrupt_value: float = float("nan")
    corrupt_batches_n: int = 0
    #: mutable counters: guarded calls failed so far / trail of trip sites
    failed: int = 0
    seen: int = 0
    stalled: int = 0
    corrupted: int = 0
    trips: list = dataclasses.field(default_factory=list)

    def matches(self, site: str) -> bool:
        return any(fnmatch.fnmatch(site, pat) for pat in self.sites)


def _plans() -> list[FaultPlan]:
    plans = getattr(_LOCAL, "plans", None)
    if plans is None:
        plans = _LOCAL.plans = []
    return plans


def active() -> bool:
    """Is any fault plan installed on this thread?"""
    return bool(getattr(_LOCAL, "plans", None))


def current_plans() -> list:
    """This thread's live fault-plan list — hand it to
    :func:`adopt_plans` on a worker thread so plans installed by the
    caller (plans are thread-local) still trip hooks evaluated there.
    The serving engine's micro-batcher does this: a test installs a
    ``serve.dispatch`` stall on the test thread, and the dispatch worker
    must see it (mirrors ``telemetry.current_sinks``/``adopt_sinks``;
    list mutation is GIL-atomic, so sharing is safe)."""
    return _plans()


def adopt_plans(plans: list) -> None:
    """Make ``plans`` (a :func:`current_plans` result from another
    thread) this thread's fault-plan list."""
    _LOCAL.plans = plans


@contextlib.contextmanager
def inject(
    *,
    shrink_caps: dict[str, int] | None = None,
    fail_first: int = 0,
    sites: tuple[str, ...] = ("*",),
    exc_factory: "Callable[[str], BaseException] | None" = None,
    skip_first: int = 0,
    stall_s: float = 0.0,
    stall_first: int = 0,
    corrupt_rows: int = 0,
    corrupt_value: float = float("nan"),
    corrupt_batches_n: int = 0,
):
    """Install a fault plan for the block; yields it (``plan.trips``
    records every synthetic failure actually raised)."""
    plan = FaultPlan(
        cap_clamps=dict(shrink_caps or {}),
        fail_first=int(fail_first),
        sites=tuple(sites),
        exc_factory=exc_factory,
        skip_first=int(skip_first),
        stall_s=float(stall_s),
        stall_first=int(stall_first),
        corrupt_rows=int(corrupt_rows),
        corrupt_value=float(corrupt_value),
        corrupt_batches_n=int(corrupt_batches_n),
    )
    _plans().append(plan)
    try:
        yield plan
    finally:
        _plans().remove(plan)


def shrink_caps(**caps: int):
    """Clamp named capacity knobs at their next sizing — e.g.
    ``shrink_caps(found_cap=8, heavy_cap=8)`` forces both compaction
    tiers to overflow on realistic inputs."""
    return inject(shrink_caps=caps)


def force_tier2_overflow(heavy_cap: int = 8, **more: int):
    """Force the tier-2 (heavy-cell) compaction to overflow by clamping
    ``heavy_cap`` (and any additional named caps) at sizing time."""
    return inject(shrink_caps={"heavy_cap": heavy_cap, **more})


def transient_errors(
    n: int = 2,
    sites: tuple[str, ...] = ("*",),
    exc_factory: "Callable[[str], BaseException] | None" = None,
    skip_first: int = 0,
):
    """Raise a synthetic transient error on the first ``n`` guarded calls
    matching ``sites`` (fnmatch patterns over hook names like
    ``"pip_join.device"`` or the stream sites ``"stream.scan_step"``,
    ``"stream.snapshot"``, ``"stream.prefetch"``). ``skip_first`` lets
    the first N matching calls through untouched — the kill-at-segment-M
    knob the stream resume tests use."""
    return inject(
        fail_first=n, sites=sites, exc_factory=exc_factory,
        skip_first=skip_first,
    )


def stalls(
    seconds: float,
    n: int = 1,
    sites: tuple[str, ...] = ("*",),
    skip_first: int = 0,
):
    """Simulate ``n`` device hangs of ``seconds`` dead time inside the
    next watchdog-guarded calls matching ``sites`` — the watchdog must
    convert each into a typed ``StalledDeviceError`` instead of letting
    the caller block."""
    return inject(
        stall_s=seconds, stall_first=n, sites=sites, skip_first=skip_first,
    )


def corrupt_batches(
    rows: int,
    value: float = float("nan"),
    n: int = 1 << 30,
    sites: tuple[str, ...] = ("stream.admit",),
):
    """Poison the first ``rows`` rows of the next ``n`` batches passing
    through :func:`maybe_corrupt` at ``sites`` with ``value`` (NaN by
    default) — modelling adversarial/garbage rows inside an otherwise
    healthy stream. The quarantine contract: exactly these rows (and no
    others) must land in the quarantine buffer."""
    return inject(
        corrupt_rows=rows, corrupt_value=value, corrupt_batches_n=n,
        sites=sites,
    )


def maybe_fail(site: str) -> None:
    """Hook: raise the planned synthetic fault for ``site``, if any.

    Placed at the top of each guarded device attempt so the retry layer
    sees the failure exactly where a real device error surfaces.
    ``skip_first`` calls pass through before the failure budget starts
    being spent (counted per plan across all matching sites).
    """
    for plan in _plans():
        if plan.fail_first and plan.matches(site):
            plan.seen += 1
            if plan.seen <= plan.skip_first:
                continue
            if plan.failed >= plan.fail_first:
                continue
            plan.failed += 1
            plan.trips.append(site)
            telemetry.record(
                "fault_injected", site=site, n=plan.failed,
                of=plan.fail_first,
            )
            if plan.exc_factory is not None:
                raise plan.exc_factory(site)
            raise TransientDeviceError(
                f"injected transient device error at {site} "
                f"({plan.failed}/{plan.fail_first})",
                site=site,
            )


def planned_stall(site: str) -> float:
    """Hook (watchdog): seconds of simulated hang planned for ``site``,
    consuming one unit of the plan's stall budget; 0.0 when none."""
    for plan in _plans():
        if (
            plan.stall_first
            and plan.stalled < plan.stall_first
            and plan.matches(site)
        ):
            plan.stalled += 1
            plan.trips.append(f"stall:{site}")
            telemetry.record(
                "fault_stall_injected", site=site,
                seconds=plan.stall_s, n=plan.stalled, of=plan.stall_first,
            )
            return float(plan.stall_s)
    return 0.0


def maybe_corrupt(site: str, batch):
    """Hook: return ``batch`` with the planned rows poisoned, or
    unchanged (same object) when no corruption plan matches. Never
    mutates the input array."""
    for plan in _plans():
        if (
            plan.corrupt_rows
            and plan.corrupted < plan.corrupt_batches_n
            and plan.matches(site)
        ):
            plan.corrupted += 1
            out = np.array(batch, dtype=np.float64, copy=True)
            k = min(int(plan.corrupt_rows), out.shape[0])
            out[:k] = plan.corrupt_value
            telemetry.record(
                "fault_batch_corrupted", site=site, rows=k,
                value=repr(plan.corrupt_value), n=plan.corrupted,
            )
            return out
    return batch


def clamp_caps(caps: dict) -> dict:
    """Apply every active plan's cap clamps to a cap dict.

    ``None`` entries (meaning "exact/unbounded") are replaced by the
    injected clamp; numeric entries are min-clamped. Without an active
    plan the dict is returned unchanged.
    """
    if not active():
        return caps
    out = dict(caps)
    for plan in _plans():
        for k, v in plan.cap_clamps.items():
            if k in out:
                out[k] = int(v) if out[k] is None else min(int(out[k]), int(v))
    if out != caps:
        telemetry.record("caps_clamped", caps={
            k: out[k] for k in out if out[k] != caps.get(k)
        })
    return out
