"""Monotonic-deadline watchdog around blocking device operations.

Port of ``mosaic_tpu/runtime/watchdog.py``. A hung kernel or copy back
blocks the caller forever — the one failure mode the retry layer cannot
see, because no exception ever surfaces. :func:`guard` runs the blocking
callable on a daemon worker thread and waits against a monotonic
deadline; when the deadline fires it raises a typed
:class:`StalledDeviceError` (a :class:`TransientDeviceError` subclass, so
:func:`runtime.retry.call_with_retry` retries it). The abandoned worker
finishes or dies with the process — its result is discarded either way.

CUDA launches are asynchronous, so a deadline only covers the device
work that ``fn`` waits for: ``fn`` must end in its own synchronisation
(the join's attempts copy their results to the host inside ``fn``). The
worker runs on the caller's current CUDA device and stream, so its
launches queue behind the caller's earlier work, as they would inline.

Deadlines resolve per site, most specific first:

1. ``MOSAIC_WATCHDOG_<SITE>`` — site name uppercased, dots/dashes to
   underscores (``pip_join.device`` -> ``MOSAIC_WATCHDOG_PIP_JOIN_DEVICE``),
   seconds; ``0`` disables the watchdog for that site;
2. ``MOSAIC_WATCHDOG_S`` — process-wide default, seconds;
3. the call's ``default_s`` argument (``None`` = no deadline).

With no deadline resolved and no stall injection active the callable
runs inline on the caller's thread — no thread hop.

Fault plans are thread-local, so :func:`guard` consults the caller's
(``faults.maybe_fail``, ``faults.planned_stall``) BEFORE dispatching; an
injected stall sleeps on the worker so the deadline genuinely fires
mid-block, exactly like a real hang. The worker does not adopt the
plans: a nested site would otherwise spend the caller's injection budget
twice.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from . import faults, telemetry
from .errors import StalledDeviceError


def _env_seconds(name: str) -> float | None:
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def env_name(site: str) -> str:
    """The per-site deadline env var for ``site``."""
    safe = "".join(
        c if c.isalnum() else "_" for c in site.upper()
    )
    return f"MOSAIC_WATCHDOG_{safe}"


def deadline_for(site: str, default_s: float | None = None) -> float | None:
    """Resolve the watchdog deadline for ``site`` in seconds.

    Per-site env beats the process-wide ``MOSAIC_WATCHDOG_S`` beats
    ``default_s``; a resolved value <= 0 disables the watchdog (None).
    """
    v = _env_seconds(env_name(site))
    if v is None:
        v = _env_seconds("MOSAIC_WATCHDOG_S")
    if v is None:
        v = default_s
    if v is None or v <= 0:
        return None
    return float(v)


def cuda_context():
    """(device index, stream) current on this thread, or None when CUDA
    has not been initialised (nothing to carry; never initialises it)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev)


def guard(site: str, fn, *args, default_s: float | None = None, **kwargs):
    """Run blocking ``fn(*args, **kwargs)`` under the site's deadline.

    Raises :class:`StalledDeviceError` when the deadline fires while
    ``fn`` is still blocked; returns ``fn``'s value (or re-raises its
    exception on the caller thread) otherwise.
    """
    faults.maybe_fail(site)
    stall_s = faults.planned_stall(site)
    deadline = deadline_for(site, default_s)
    if deadline is None and not stall_s:
        return fn(*args, **kwargs)

    done = threading.Event()
    box: dict = {}
    sinks = telemetry.current_sinks()  # capture scopes span the worker
    trace = telemetry.current_trace()  # the active span does too
    cuda = cuda_context()  # and the caller's device and stream

    def work():
        try:
            telemetry.adopt_sinks(sinks)
            telemetry.adopt_trace(trace)
            if stall_s:
                time.sleep(stall_s)
            if cuda is None:
                box["value"] = fn(*args, **kwargs)
            else:
                with torch.cuda.device(cuda[0]), torch.cuda.stream(cuda[1]):
                    box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised on caller
            box["error"] = e
        finally:
            done.set()

    t0 = time.monotonic()
    worker = threading.Thread(
        target=work, name=f"mosaic-watchdog:{site}", daemon=True
    )
    worker.start()
    if not done.wait(timeout=deadline):
        elapsed = time.monotonic() - t0
        telemetry.record(
            "watchdog_stall", site=site,
            deadline_s=round(float(deadline), 3),
            elapsed_s=round(elapsed, 3),
        )
        raise StalledDeviceError(
            f"{site}: blocking device operation exceeded its "
            f"{deadline:.3f}s watchdog deadline "
            f"(set {env_name(site)} to tune)",
            site=site, deadline_s=float(deadline), elapsed_s=elapsed,
        )
    if "error" in box:
        raise box["error"]
    return box["value"]
