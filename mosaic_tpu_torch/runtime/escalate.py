"""Capacity-escalation engine: bounded geometric cap growth to exactness.

The join paths bound their stream-compaction shapes with static caps
(``found_cap``/``heavy_cap``/``compact_block`` — `sql/join.py`); rows past
a cap come back as the :data:`~mosaic_tpu_torch.sql.join.OVERFLOW` sentinel
instead of a wrong answer. This module owns the ONE policy that turns
that sentinel into an exact answer: re-run with every involved cap grown
``growth``× (clamped to its ceiling), up to ``max_attempts`` times. It is
a host copy of ``mosaic_tpu/runtime/escalate.py``, telemetry events
included (``capacity_overflow`` per overflowing attempt,
``escalation_resolved`` when a later attempt is exact).

Env knobs: ``MOSAIC_ESCALATE_ATTEMPTS`` (default 16),
``MOSAIC_ESCALATE_GROWTH`` (default 2).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from . import telemetry
from .errors import CapacityOverflow


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    growth: int = 2
    max_attempts: int = 16

    @classmethod
    def from_env(cls) -> "EscalationPolicy":
        try:
            attempts = int(os.environ.get("MOSAIC_ESCALATE_ATTEMPTS", 16))
        except ValueError:
            attempts = 16
        try:
            growth = int(os.environ.get("MOSAIC_ESCALATE_GROWTH", 2))
        except ValueError:
            growth = 2
        return cls(growth=max(growth, 2), max_attempts=max(attempts, 1))


def run_escalating(
    attempt_fn: Callable[[dict], object],
    caps: dict[str, int],
    ceilings: dict[str, int],
    *,
    overflow_count: Callable[[object], int],
    stage: str = "",
    policy: EscalationPolicy | None = None,
):
    """Run ``attempt_fn(caps)`` until ``overflow_count(result)`` is zero.

    ``caps`` maps cap names to their starting values (only the caps that
    should grow belong here); ``ceilings`` bounds each cap's growth (the
    memory ceiling — typically the batch row count, at which overflow is
    structurally impossible). After an overflowing attempt every cap is
    grown ``policy.growth``× (clamped); when the attempt budget runs out
    or every cap already sits at its ceiling while rows still overflow,
    :class:`CapacityOverflow` is raised — the sentinel NEVER escapes
    through this wrapper.

    Returns ``(result, caps)`` — the exact result and the cap set that
    produced it.
    """
    policy = policy or EscalationPolicy.from_env()
    caps = {k: int(v) for k, v in caps.items()}
    attempt = 0
    while True:
        attempt += 1
        result = attempt_fn(dict(caps))
        n_over = int(overflow_count(result))
        if not n_over:
            if attempt > 1:
                telemetry.record(
                    "escalation_resolved", stage=stage, attempts=attempt,
                    caps=dict(caps),
                )
            return result, caps
        at_ceiling = all(
            caps[k] >= int(ceilings.get(k, caps[k])) for k in caps
        ) or not caps
        telemetry.record(
            "capacity_overflow", stage=stage, attempt=attempt,
            overflow=n_over, caps=dict(caps), at_ceiling=at_ceiling,
        )
        if at_ceiling or attempt >= policy.max_attempts:
            raise CapacityOverflow(
                f"{stage or 'device call'}: {n_over} rows still overflow "
                f"after {attempt} attempts (caps={caps})",
                stage=stage, caps=caps, attempts=attempt,
                overflow_count=n_over,
            )
        caps = {
            k: min(
                max(v * policy.growth, v + 1), int(ceilings.get(k, v * policy.growth))
            )
            for k, v in caps.items()
        }
