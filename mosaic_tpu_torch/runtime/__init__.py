"""Runtime resilience layer of the port: typed errors, capacity
escalation, transient retry, graceful degradation, fault injection, the
watchdog and telemetry (port of ``mosaic_tpu/runtime``; checkpoints and
quarantine come with streaming).

- :mod:`errors`     — the typed taxonomy (`CapacityOverflow`,
  `TransientDeviceError`, `RetryExhausted`, `DegradedResult`) and
  :func:`is_transient`, which never retries the port's device errors;
- :mod:`escalate`   — the bounded geometric cap-growth loop;
- :mod:`retry`      — bounded transient retry with backoff and an
  optional host-oracle fallback (degradation);
- :mod:`telemetry`  — the structured event spine;
- :mod:`faults`     — context-manager fault injection;
- :mod:`watchdog`   — monotonic-deadline guard around blocking device
  operations (``MOSAIC_WATCHDOG_*`` knobs).
"""

from .errors import (
    CapacityOverflow,
    DegradedResult,
    KernelCompileError,
    KernelLaunchError,
    MosaicRuntimeError,
    RetryExhausted,
    StalledDeviceError,
    TransientDeviceError,
    is_transient,
)
from .escalate import EscalationPolicy, run_escalating
from .retry import RetryPolicy, backoff_delays, call_with_retry, with_retry
from . import faults, telemetry, watchdog

__all__ = [
    "CapacityOverflow",
    "DegradedResult",
    "EscalationPolicy",
    "KernelCompileError",
    "KernelLaunchError",
    "MosaicRuntimeError",
    "RetryExhausted",
    "RetryPolicy",
    "StalledDeviceError",
    "TransientDeviceError",
    "backoff_delays",
    "call_with_retry",
    "faults",
    "is_transient",
    "run_escalating",
    "telemetry",
    "watchdog",
    "with_retry",
]
