"""Runtime layer of the port: the typed errors and the capacity
escalation loop (`escalate.run_escalating`). Retry, fault injection and
telemetry are later slices."""

from .errors import CapacityOverflow, MosaicRuntimeError
from .escalate import run_escalating

__all__ = ["CapacityOverflow", "MosaicRuntimeError", "run_escalating"]
