"""MosaicContext: backend binding + function registry.

Port of ``mosaic_tpu/context.py``. Reference analog:
`functions/MosaicContext.scala:28-48,792-818` — the singleton that binds
an IndexSystem + GeometryAPI (+ RasterAPI), registers ~120 SQL functions
by name, and exposes the `functions` DSL — and `MosaicExpressionConfig`
(`functions/MosaicExpressionConfig.scala:17-76`), the config snapshot
expressions carry. The "Spark conf" contract is a typed dataclass;
"registration" is a name->callable dict. The index system and the
function namespace are imported at first use, so ``import
mosaic_tpu_torch`` (and `sql/join.py`, which reads
:func:`current_config`) loads neither.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from types import SimpleNamespace

from .core.index.base import IndexSystem

_CUSTOM_RE = re.compile(
    r"CUSTOM\(\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)"
    r"\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)"
)


def index_system_factory(spec: "str | IndexSystem") -> IndexSystem:
    """'H3' | 'BNG' | 'CUSTOM(xmin,xmax,ymin,ymax,splits,rootX,rootY)' or an
    instance (reference: `core/index/IndexSystemFactory.scala:3-26`)."""
    if isinstance(spec, IndexSystem):
        return spec
    name = spec.strip()
    if name.upper() == "H3":
        from .core.index.h3 import H3IndexSystem

        return H3IndexSystem()
    if name.upper() == "BNG":
        from .core.index.bng import BNGIndexSystem

        return BNGIndexSystem()
    m = _CUSTOM_RE.fullmatch(name.upper())
    if m:
        from .core.index.custom import CustomIndexSystem, GridConf

        xmin, xmax, ymin, ymax = (float(m.group(i)) for i in range(1, 5))
        splits, root_x, root_y = (int(m.group(i)) for i in range(5, 8))
        return CustomIndexSystem(
            GridConf(xmin, xmax, ymin, ymax, splits, root_x, root_y)
        )
    raise ValueError(f"unknown index system {spec!r}")


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Typed analog of the `spark.databricks.labs.mosaic.*` confs
    (`package.scala:20-25`)."""

    index_system: str = "H3"
    geometry_backend: str = "device"  # 'device' (torch, the card) |
    # 'oracle' (host f64) | 'native' (independent C++ second engine,
    # ESRI-engine role)
    cell_id_type: str = "long"  # 'long' | 'string'
    raster_checkpoint: str = "/tmp/mosaic_tpu/raster_checkpoint"
    #: epsilon-band borderline recheck in `sql.join.pip_join`: borderline
    #: f32 cell/edge decisions re-evaluate against the f64 host oracle;
    #: off by default (pure-throughput mode)
    exact_recheck: bool = False

    def __post_init__(self):
        if self.geometry_backend not in ("device", "oracle", "native"):
            raise ValueError(
                f"geometry_backend must be 'device', 'oracle' or "
                f"'native', got {self.geometry_backend!r}"
            )
        if self.cell_id_type not in ("long", "string"):
            raise ValueError(
                f"cell_id_type must be 'long' or 'string', got "
                f"{self.cell_id_type!r}"
            )


class MosaicContext:
    """Process-wide context (reference: MosaicContext singleton :792-818)."""

    _lock = threading.RLock()  # context() may call build() under the lock
    _instance: "MosaicContext | None" = None

    def __init__(self, config: MosaicConfig, index_system: IndexSystem):
        self.config = config
        self.index_system = index_system
        self.functions = _build_namespace()

    # ------------------------------------------------------------- builders
    @classmethod
    def build(
        cls,
        index_system: "str | IndexSystem" = "H3",
        geometry_backend: str = "device",
        **kwargs,
    ) -> "MosaicContext":
        idx = index_system_factory(index_system)
        cfg = MosaicConfig(
            index_system=getattr(idx, "name", str(index_system)),
            geometry_backend=geometry_backend,
            **kwargs,
        )
        ctx = cls(cfg, idx)
        with cls._lock:
            cls._instance = ctx
        # the reference's enable_mosaic registers the kepler magic
        # (`python/mosaic/api/enable.py:13-68`); best-effort here too
        try:
            from .viz import register_kepler_magic

            register_kepler_magic()
        except Exception:  # lint: broad-except-ok (notebooks only, never fatal)
            pass
        return ctx

    @classmethod
    def context(cls) -> "MosaicContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls.build()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    # ------------------------------------------------------------- registry
    def register(self, prefix: str = "") -> dict[str, callable]:
        """Name -> callable map, the analog of SQL registration
        (`functions/MosaicContext.scala:93-426`). Names match the reference's
        SQL names so a user can dispatch by string."""
        from . import functions as F

        return {f"{prefix}{name}": getattr(F, name) for name in F.__all__}


def _build_namespace() -> SimpleNamespace:
    from . import functions as F

    return SimpleNamespace(**{name: getattr(F, name) for name in F.__all__})


def current_context() -> MosaicContext:
    return MosaicContext.context()


def current_config() -> MosaicConfig:
    return MosaicContext.context().config
