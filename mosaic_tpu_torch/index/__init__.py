"""Mutable-index layer: epochal, durable, crash-consistent chip indexes
(`epoch.py`; port of ``mosaic_tpu/index``). Not to be confused with
`mosaic_tpu_torch.core.index`, the grid index *systems* (H3/BNG/custom)
— this package owns index *instances* that change over time.
"""

from __future__ import annotations

from ..runtime.errors import EpochFingerprintMismatch, EpochLogCorrupt
from .epoch import EpochalIndex, chip_index_equal

__all__ = [
    "EpochalIndex",
    "chip_index_equal",
    "EpochLogCorrupt",
    "EpochFingerprintMismatch",
]
