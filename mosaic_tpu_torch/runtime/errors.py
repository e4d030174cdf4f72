"""Typed error taxonomy of the port's runtime resilience layer.

Port of ``mosaic_tpu/runtime/errors.py`` (the classes the join, the
durable stream and the serving engine raise).
Every failure a device join path can hit maps to one of three classes —
capacity (the bounded-shape contract overflowed), transient (the same
call may succeed if tried again), and degraded (the device path was
abandoned and the f64 host oracle answered instead).

What differs from the reference: :func:`is_transient` never calls the
port's own device errors transient — :class:`~mosaic_tpu_torch.
DeviceUnavailable`, :class:`KernelCompileError`, :class:`KernelLaunchError`
and any error whose text names a CUDA error — whatever else their text
says. Retrying them cannot help, and answering them from the host oracle
would hide a card that is missing or broken behind a slow exact answer.
"""

from __future__ import annotations

import numpy as np

from .. import DeviceUnavailable


class MosaicRuntimeError(RuntimeError):
    """Base of every typed runtime-resilience error."""


class CapacityOverflow(MosaicRuntimeError):
    """A bounded-capacity device path overflowed and escalation could not
    (or was not allowed to) grow the caps to an exact answer.

    Carries the escalation trail; ``overflow_count`` is the number of rows
    whose answer was still unknown at the last attempt.
    """

    def __init__(
        self,
        message: str,
        *,
        stage: str = "",
        caps: dict | None = None,
        attempts: int = 0,
        overflow_count: int = 0,
    ):
        super().__init__(message)
        self.stage = stage
        self.caps = dict(caps or {})
        self.attempts = attempts
        self.overflow_count = overflow_count


class TransientDeviceError(MosaicRuntimeError):
    """A failure that may succeed on retry (the class fault injection
    raises synthetically)."""

    def __init__(self, message: str, *, site: str = ""):
        super().__init__(message)
        self.site = site


class StalledDeviceError(TransientDeviceError):
    """A blocking device operation exceeded its watchdog deadline
    (`runtime/watchdog.py`). A stall rides the transient retry path:
    bounded retry, then degradation or a typed failure — never a silent
    hang. ``elapsed_s`` is how long the operation had been blocked."""

    def __init__(
        self, message: str, *, site: str = "", deadline_s: float = 0.0,
        elapsed_s: float = 0.0,
    ):
        super().__init__(message, site=site)
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


class RetryExhausted(MosaicRuntimeError):
    """The bounded transient-retry budget ran out without a success.

    ``last`` is the final underlying exception; ``attempts`` how many
    tries were made.
    """

    def __init__(self, message: str, *, attempts: int = 0, last=None):
        super().__init__(message)
        self.attempts = attempts
        self.last = last


class Overloaded(MosaicRuntimeError):
    """The serving engine refused (or abandoned) a request under load.

    Raised by `serve/admission.py` and `serve/batcher.py` instead of
    queueing without bound: the bounded request queue was full at
    admission (``reason="queue_full"``), the request's deadline expired
    before its results could be delivered (``reason="deadline"``), or the
    engine shut down with the request still queued
    (``reason="shutdown"``). Typed so callers can tell load shedding —
    retry later, against another replica — from a wrong answer, which
    this never is.
    """

    def __init__(
        self,
        message: str,
        *,
        reason: str = "",
        queue_depth: int = 0,
        capacity: int = 0,
        deadline_s: float = 0.0,
        elapsed_s: float = 0.0,
    ):
        super().__init__(message)
        self.reason = reason
        self.queue_depth = queue_depth
        self.capacity = capacity
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


class RasterDecodeError(MosaicRuntimeError, ValueError):
    """The native GeoTIFF engine rejected a file.

    Raised by :func:`mosaic_tpu_torch.raster.read_raster` whenever
    ``mg_tiff_read`` returns a nonzero rc: the rc is mapped to the
    decoder's failure taxonomy (``native/src/tiff.cpp``) and carried
    alongside the path, so callers can tell "not a TIFF" from
    "unsupported layout" from plain IO failure. A decode failure is a
    property of the bytes on disk, never transient (it is a
    ``ValueError``, which :func:`is_transient` refuses).
    """

    def __init__(self, message: str, *, path: str = "", rc: int = 0):
        super().__init__(message)
        self.path = path
        self.rc = rc


class EpochLogCorrupt(MosaicRuntimeError):
    """A delta-log record INSIDE the valid prefix failed validation
    (unreadable sidecar, payload checksum mismatch, missing epoch in the
    sequence) while LATER records are intact (`index/epoch.py`).

    A corrupt *tail* is the expected kill-mid-write residue and is
    truncated (``epoch_log_truncated`` telemetry); corruption with valid
    successors means the bytes rotted or the directory was spliced —
    replay refuses rather than reconstruct a wrong index.
    """

    def __init__(self, message: str, *, log_dir: str = "", epoch: int = -1):
        super().__init__(message)
        self.log_dir = log_dir
        self.epoch = epoch


class EpochFingerprintMismatch(MosaicRuntimeError):
    """An epoch identity failed to line up: a delta record's ``prev``
    hash does not chain from its predecessor, a log was written for
    another index system (`index/epoch.py EpochalIndex.replay`), or a
    durable-stream resume presented an index from another epoch than the
    one its snapshot was taken under (`sql/stream.py StreamJoin.resume`).
    A refusal — continuing would mix results joined against two indexes
    into one answer.
    """

    def __init__(
        self, message: str, *, expected: str = "", actual: str = "",
        epoch: int = -1,
    ):
        super().__init__(message)
        self.expected = expected
        self.actual = actual
        self.epoch = epoch


class KernelCompileError(RuntimeError):
    """A hand-written CUDA kernel could not be built (no ``nvcc``, or
    ``nvcc`` failed on its source). Never transient."""


class KernelLaunchError(RuntimeError):
    """A hand-written CUDA kernel's entry point returned a CUDA error.
    Never transient."""


#: substrings that mark an exception as transient (the reference's list,
#: matched case-insensitively against ``repr(exc)``)
_TRANSIENT_MARKERS = (
    "http 500",
    "http error 500",
    "remote_compile",
    "remote compile",
    "unavailable",
    "deadline exceeded",
    "deadline_exceeded",
    "socket closed",
    "connection reset",
    "connection refused",
    "broken pipe",
    "tunnel",
    "internal: ",
)

#: substrings naming a CUDA error: such an exception is never transient
_CUDA_MARKERS = (
    "cuda error",
    "cudaerror",
    "cuda_error",
    "cuda out of memory",
    "cublas_status",
    "cudnn_status",
)

#: the port's own device errors, refused by type
_DEVICE_ERRORS = (DeviceUnavailable, KernelCompileError, KernelLaunchError)


def is_transient(exc: BaseException) -> bool:
    """Should this exception be retried?  `TransientDeviceError` always;
    the port's device errors (by type, or by a CUDA error in their text)
    never; other exceptions only when their text carries a known
    transient marker (programming errors like ValueError never are)."""
    if isinstance(exc, TransientDeviceError):
        return True
    if isinstance(
        exc, _DEVICE_ERRORS + (ValueError, TypeError, KeyError, AttributeError)
    ):
        return False
    text = repr(exc).lower()
    if any(m in text for m in _CUDA_MARKERS):
        return False
    return any(m in text for m in _TRANSIENT_MARKERS)


class DegradedResult(np.ndarray):
    """An ndarray view flagging a graceful-degradation result.

    Returned (instead of a plain array) when the device path failed past
    its retry budget and the f64 host oracle answered instead: values are
    exact, but the call did not run on the fast path. Behaves exactly
    like its base array everywhere else; resilience-aware callers check
    ``getattr(r, "degraded", False)``.
    """

    degraded: bool = True

    @classmethod
    def wrap(
        cls, value, *, reason: str = "", attempts: int = 0,
        detail: dict | None = None,
    ) -> "DegradedResult":
        out = np.asarray(value).view(cls)
        out.reason = reason
        out.attempts = attempts
        out.detail = dict(detail or {})
        return out

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.reason = getattr(obj, "reason", "")
        self.attempts = getattr(obj, "attempts", 0)
        self.detail = getattr(obj, "detail", {})
