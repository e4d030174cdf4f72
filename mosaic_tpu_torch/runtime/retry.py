"""Bounded transient-failure retry with backoff, jitter, and degradation.

Port of ``mosaic_tpu/runtime/retry.py``: one policy object, one
functional wrapper, one decorator. On budget exhaustion the wrapper
either raises :class:`RetryExhausted` or — when the caller supplies a
``fallback`` (typically the f64 host oracle) — returns the fallback's
value wrapped as :class:`DegradedResult`. Only errors that
:func:`~.errors.is_transient` accepts are retried; the port's own device
errors never are (see `runtime/errors.py`), so they never reach a
fallback.

Every caller in the port uses the default :class:`RetryPolicy` (3 tries,
0.05 s first backoff, 2 s ceiling, 60 s budget); the reference's
``MOSAIC_RETRY_ATTEMPTS``/``_BASE_S``/``_MAX_S``/``_BUDGET_S`` knobs are
not ported until a caller needs other values. One knob is read, as the
reference reads it:

- ``MOSAIC_RETRY_SEED``  seed the backoff jitter (default: entropy), so
  a retry schedule is reproducible run to run (see :func:`_jitter_rng`)
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import random
import time as _time
from typing import Callable, Iterator

from . import telemetry
from .errors import DegradedResult, RetryExhausted, is_transient


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt *n* sleeps
    ``min(base * growth**(n-1), max_delay)``, scaled by up to ``jitter``
    of itself (uniform), all inside ``timeout_s`` total wall clock."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    timeout_s: float = 60.0
    growth: float = 2.0
    jitter: float = 0.25


def _jitter_rng(rng: "random.Random | None") -> "random.Random":
    """The jitter source: an injected ``rng`` wins; else a fresh
    ``random.Random(MOSAIC_RETRY_SEED)`` when the env knob is set (each
    schedule restarts the sequence: deterministic under test; a value
    that is not an integer seeds by its text); else the module-level
    entropy-seeded generator."""
    if rng is not None:
        return rng
    seed = os.environ.get("MOSAIC_RETRY_SEED")
    if seed is not None:
        try:
            return random.Random(int(seed))
        except ValueError:
            return random.Random(seed)
    return random  # the module (duck-typed: exposes .random())


def backoff_delays(
    policy: RetryPolicy, rng: "random.Random | None" = None
) -> Iterator[float]:
    """The policy's backoff schedule (one delay per retry, jittered).

    ``rng`` injects the jitter source; without it, ``MOSAIC_RETRY_SEED``
    makes every schedule identical (see :func:`_jitter_rng`).
    """
    r = _jitter_rng(rng)
    delay = policy.base_delay_s
    while True:
        scale = 1.0 + policy.jitter * (2.0 * r.random() - 1.0)
        yield min(delay, policy.max_delay_s) * max(scale, 0.0)
        delay = min(delay * policy.growth, policy.max_delay_s)


def call_with_retry(
    fn: Callable,
    *args,
    policy: RetryPolicy | None = None,
    classify: Callable[[BaseException], bool] = is_transient,
    fallback: Callable[[], object] | None = None,
    label: str = "",
    sleep: Callable[[float], None] = _time.sleep,
    rng: "random.Random | None" = None,
    **kwargs,
):
    """Run ``fn(*args, **kwargs)``, retrying transient failures.

    Non-transient exceptions (per ``classify``) propagate immediately.
    Transient ones retry with backoff until the attempt or wall-clock
    budget runs out; then either ``fallback()`` answers (wrapped as
    :class:`DegradedResult` and logged) or :class:`RetryExhausted` is
    raised chaining the last error. Every retry and the degradation emit
    structured telemetry.
    """
    policy = policy or RetryPolicy()
    name = label or getattr(fn, "__name__", "call")
    delays = backoff_delays(policy, rng=rng)
    t0 = _time.monotonic()
    last: BaseException | None = None
    attempt = 0
    while attempt < max(policy.max_attempts, 1):
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classified below
            if not classify(e):
                raise
            last = e
            telemetry.record(
                "transient_retry", label=name, attempt=attempt,
                error=repr(e)[:200],
            )
            delay = next(delays)
            out_of_budget = (
                attempt >= policy.max_attempts
                or _time.monotonic() - t0 + delay > policy.timeout_s
            )
            if out_of_budget:
                break
            sleep(delay)
    if fallback is not None:
        telemetry.record(
            "degraded", label=name, attempts=attempt,
            error=repr(last)[:200],
        )
        logging.getLogger("mosaic_tpu_torch.runtime").warning(
            "%s: device path failed %d times (%r); degrading to host "
            "fallback", name, attempt, last,
        )
        return DegradedResult.wrap(
            fallback(),
            reason=f"{name}: retries exhausted ({last!r})"[:300],
            attempts=attempt,
        )
    telemetry.record(
        "retry_exhausted", label=name, attempts=attempt,
        error=repr(last)[:200],
    )
    raise RetryExhausted(
        f"{name}: transient-failure retry budget exhausted after "
        f"{attempt} attempts (last: {last!r})",
        attempts=attempt,
        last=last,
    ) from last


def with_retry(
    policy: RetryPolicy | None = None,
    classify: Callable[[BaseException], bool] = is_transient,
    fallback: Callable[[], object] | None = None,
    label: str = "",
):
    """Decorator form of :func:`call_with_retry`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(
                fn, *args, policy=policy, classify=classify,
                fallback=fallback, label=label or fn.__name__, **kwargs,
            )

        return wrapped

    return deco
