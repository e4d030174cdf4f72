"""The process-wide configuration the entry points read their defaults
from (port of ``MosaicConfig``/``current_config`` in
``mosaic_tpu/context.py``; the function registry and the index-system
factory are later slices)."""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Typed analog of the ``spark.databricks.labs.mosaic.*`` confs."""

    #: epsilon-band borderline recheck in `sql.join.pip_join`: borderline
    #: f32 cell/edge decisions re-evaluate against the f64 host oracle;
    #: off by default (pure-throughput mode)
    exact_recheck: bool = False


class MosaicContext:
    """Process-wide context holding the :class:`MosaicConfig`."""

    _lock = threading.Lock()
    _instance: "MosaicContext | None" = None

    def __init__(self, config: MosaicConfig):
        self.config = config

    @classmethod
    def build(cls, **config) -> "MosaicContext":
        """Install a context whose config has the given fields."""
        ctx = cls(MosaicConfig(**config))
        with cls._lock:
            cls._instance = ctx
        return ctx

    @classmethod
    def context(cls) -> "MosaicContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(MosaicConfig())
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None


def current_context() -> MosaicContext:
    return MosaicContext.context()


def current_config() -> MosaicConfig:
    return MosaicContext.context().config
