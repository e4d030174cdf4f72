"""The dispatch core's resilience composition (port of the
``guarded_call`` part of ``mosaic_tpu/dispatch/core.py``; the compile
caches, warmup and the sharded lanes are later slices)."""

from __future__ import annotations

from ..runtime import watchdog as _watchdog
from ..runtime.retry import call_with_retry


def guarded_call(
    site: str,
    fn,
    *args,
    default_s=None,
    policy=None,
    fallback=None,
    label=None,
    classify=None,
    retry: bool = True,
    **kwargs,
):
    """THE watchdog/retry/degradation composition, written once.

    Runs ``fn(*args, **kwargs)`` under the ``site`` watchdog deadline
    (per-site ``MOSAIC_WATCHDOG_<SITE>`` beats global ``MOSAIC_WATCHDOG_S``
    beats ``default_s``; the site doubles as the fault-injection hook),
    retried on transient failures per ``policy`` (the default
    :class:`~mosaic_tpu_torch.runtime.retry.RetryPolicy` when None); past the budget it degrades through
    ``fallback`` (:class:`DegradedResult`) or raises
    :class:`RetryExhausted`. ``retry=False`` keeps only the watchdog.
    """

    def attempt():
        return _watchdog.guard(site, fn, *args, default_s=default_s, **kwargs)

    if not retry:
        return attempt()
    kw = {"policy": policy, "fallback": fallback, "label": label or site}
    if classify is not None:
        kw["classify"] = classify
    return call_with_retry(attempt, **kw)
