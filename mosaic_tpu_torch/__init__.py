"""mosaic_tpu_torch — the PyTorch/CUDA port of mosaic_tpu.

The same system as ``mosaic_tpu`` (the JAX package, which stays the
reference), with the same module layout and names, written against
PyTorch for an NVIDIA Hopper card. Its hand-written kernels live in
``kernels/csrc`` and are built with ``nvcc`` on first use.

Dtype and device policy (no flags, no fallbacks):

- device coordinates are float32 (:data:`FLOAT`); host coordinates stay
  float64 numpy;
- cell ids are native ``torch.int64`` (:data:`CELL`) — PyTorch needs no
  64-bit switch;
- entry points run on the card. A caller who wants the CPU says
  ``device="cpu"`` (the tests do); with no CUDA and no such request they
  raise :class:`DeviceUnavailable` instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

FLOAT = torch.float32
CELL = torch.int64

__version__ = "0.1.0"


class DeviceUnavailable(RuntimeError):
    """An entry point was asked to run on the card and there is none."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card. Raises :class:`DeviceUnavailable` for a CUDA device
    (explicit or default) when CUDA is not available."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "mosaic_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain torch path"
        )
    return dev


# The package's own names are defined before these imports: the modules
# below import ``resolve_device`` and ``FLOAT`` from here.
from .core.types import (  # noqa: E402
    GeometryBuilder,
    GeometryType,
    PackedGeometry,
    PaddedGeometry,
)
from .context import MosaicConfig, MosaicContext, index_system_factory  # noqa: E402
from .runtime.errors import (  # noqa: E402
    CapacityOverflow,
    DegradedResult,
    MosaicRuntimeError,
    RetryExhausted,
    TransientDeviceError,
)


def enable_mosaic(index_system="H3", geometry_backend="device", **kwargs):
    """Build and install the process context, as the reference's
    ``enable_mosaic`` does."""
    return MosaicContext.build(index_system, geometry_backend, **kwargs)


__all__ = [
    "CELL",
    "FLOAT",
    "CapacityOverflow",
    "DegradedResult",
    "DeviceUnavailable",
    "GeometryBuilder",
    "GeometryType",
    "MosaicConfig",
    "MosaicContext",
    "MosaicRuntimeError",
    "PackedGeometry",
    "PaddedGeometry",
    "RetryExhausted",
    "TransientDeviceError",
    "enable_mosaic",
    "index_system_factory",
    "resolve_device",
    "__version__",
]
