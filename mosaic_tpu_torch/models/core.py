"""Model-support primitives: the durable array-table checkpoints that
`SpatialKNN` appends each iteration to.

Port of the part of ``mosaic_tpu/models/core.py`` that the batch KNN
model uses (``CheckpointManager``; the iteration skeletons are not
ported). A table is a directory of ``.npz`` array bundles: each
iteration's arrays are one file, append adds a file, load concatenates.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np


class CheckpointManager:
    """Durable array-table checkpoints (append / load / meta).

    A "table" is a dict[str, np.ndarray] of equal-length columns; each
    append writes ``part-<n>.npz``."""

    def __init__(self, location: str, overwrite: bool = False):
        self.dir = Path(location)
        if overwrite and self.dir.exists():
            shutil.rmtree(self.dir)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _parts(self) -> list[Path]:
        return sorted(self.dir.glob("part-*.npz"))

    def append(self, table: dict[str, np.ndarray]) -> None:
        """Write one part (``load()`` materializes the union)."""
        n = len(self._parts())
        np.savez(self.dir / f"part-{n:05d}.npz", **table)

    def load(self) -> dict[str, np.ndarray]:
        parts = self._parts()
        if not parts:
            return {}
        loaded = [dict(np.load(p, allow_pickle=True)) for p in parts]
        keys = loaded[0].keys()
        return {k: np.concatenate([d[k] for d in loaded]) for k in keys}

    def write_meta(self, meta: dict) -> None:
        (self.dir / "meta.json").write_text(json.dumps(meta, default=str))

    def read_meta(self) -> dict:
        p = self.dir / "meta.json"
        return json.loads(p.read_text()) if p.exists() else {}
