"""Typed errors of the port's runtime layer (the subset of
``mosaic_tpu/runtime/errors.py`` this slice raises)."""

from __future__ import annotations


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
