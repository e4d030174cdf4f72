"""Runtime resilience layer of the port: typed errors, capacity
escalation, transient retry, graceful degradation, fault injection, the
watchdog and telemetry, checkpoints and quarantine (port of
``mosaic_tpu/runtime``).

- :mod:`errors`     — the typed taxonomy (`CapacityOverflow`,
  `TransientDeviceError`, `RetryExhausted`, `DegradedResult`,
  `Overloaded`, `EpochLogCorrupt`, `EpochFingerprintMismatch`) and
  :func:`is_transient`, which never retries the port's device errors;
- :mod:`escalate`   — the bounded geometric cap-growth loop;
- :mod:`retry`      — bounded transient retry with backoff and an
  optional host-oracle fallback (degradation);
- :mod:`telemetry`  — the structured event spine;
- :mod:`faults`     — context-manager fault injection;
- :mod:`watchdog`   — monotonic-deadline guard around blocking device
  operations (``MOSAIC_WATCHDOG_*`` knobs);
- :mod:`checkpoint` — checksummed snapshot store (atomic write, corrupt-
  snapshot skip on load) for resumable streaming runs;
- :mod:`quarantine` — pre-admission input validation: poisoned rows land
  in a reported quarantine buffer instead of the device fold.
"""

from .errors import (
    CapacityOverflow,
    DegradedResult,
    EpochFingerprintMismatch,
    EpochLogCorrupt,
    KernelCompileError,
    KernelLaunchError,
    MosaicRuntimeError,
    Overloaded,
    RetryExhausted,
    StalledDeviceError,
    TransientDeviceError,
    is_transient,
)
from .escalate import EscalationPolicy, run_escalating
from .retry import RetryPolicy, backoff_delays, call_with_retry, with_retry
from . import checkpoint, faults, quarantine, telemetry, watchdog

__all__ = [
    "CapacityOverflow",
    "DegradedResult",
    "EpochFingerprintMismatch",
    "EpochLogCorrupt",
    "EscalationPolicy",
    "KernelCompileError",
    "KernelLaunchError",
    "MosaicRuntimeError",
    "Overloaded",
    "RetryExhausted",
    "RetryPolicy",
    "StalledDeviceError",
    "TransientDeviceError",
    "backoff_delays",
    "call_with_retry",
    "checkpoint",
    "faults",
    "is_transient",
    "quarantine",
    "run_escalating",
    "telemetry",
    "watchdog",
    "with_retry",
]
