"""Model-support primitives: checkpoints + iterate-until-converged.

Port of ``mosaic_tpu/models/core.py``: the durable array-table
checkpoints (`SpatialKNN` appends to them each iteration) and the two
iteration skeletons. A table is a directory of ``.npz`` array bundles:
each iteration's arrays are one file, append adds a file, load
concatenates. A state that lives on the card is copied to the host when
it is checkpointed, so the part files are the reference's, array for
array.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Callable

import numpy as np
import torch


class CheckpointManager:
    """Durable array-table checkpoints (append / overwrite / load / meta).

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

    def overwrite(self, table: dict[str, np.ndarray]) -> None:
        for p in self._parts():
            p.unlink()
        np.savez(self.dir / "part-00000.npz", **table)

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

    def delete(self) -> None:
        if self.dir.exists():
            shutil.rmtree(self.dir)


def _col(name: str, v) -> np.ndarray:
    """One checkpoint column: a tensor (on any device) copied to the host,
    anything else through ``np.asarray``; ``atleast_1d`` because ``load()``
    concatenates columns and 0-d states cannot be concatenated."""
    try:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.atleast_1d(np.asarray(v))
    except Exception as e:
        # a dropped column would make parts key-inconsistent and break (or
        # silently thin) load() on restore
        raise TypeError(
            f"checkpointed state {name!r} is not array-convertible: {e}"
        ) from e


class IterativeTransformer:
    """Iterate ``step`` until ``should_stop`` or ``max_iterations``
    (reference: `IterativeTransformer.iterate:49-87`). State is whatever the
    caller threads through; each iteration may persist via a
    CheckpointManager."""

    def __init__(
        self,
        step: Callable,
        should_stop: Callable,
        max_iterations: int,
    ):
        self.step = step
        self.should_stop = should_stop
        self.max_iterations = max_iterations
        self.iterations_run = 0

    def iterate(self, state):
        prev = state
        for i in range(1, self.max_iterations + 1):
            self.iterations_run = i
            state = self.step(prev, i)
            if self.should_stop(prev, state):
                break
            prev = state
        return state


class BinaryTransformer(IterativeTransformer):
    """Left/right two-table iterative transformer (reference:
    `models/core/BinaryTransformer.scala`): a fixed RIGHT table joined
    against an evolving LEFT state each iteration.

    ``join_step(left_state, right, iteration)`` produces the next left
    state; the right side is threaded unchanged (and may live on the card,
    e.g. a :class:`~mosaic_tpu_torch.sql.join.ChipIndex`). With a
    ``checkpoint``, each iteration appends its state (a dict's columns, or
    one ``left`` column) and an ``iteration`` column."""

    def __init__(
        self,
        join_step: Callable,
        should_stop: Callable,
        max_iterations: int,
        right=None,
        checkpoint: "CheckpointManager | None" = None,
    ):
        self.right = right
        self.checkpoint = checkpoint

        def step(left, i):
            out = join_step(left, self.right, i)
            if self.checkpoint is not None:
                if isinstance(out, dict):
                    part = {k: _col(k, v) for k, v in out.items() if k != "iteration"}
                else:
                    part = {"left": _col("left", out)}
                part["iteration"] = np.asarray([i])
                self.checkpoint.append(part)
            return out

        super().__init__(step, should_stop, max_iterations)

    def transform(self, left):
        """Run the iteration from an initial left state (ML-style verb)."""
        return self.iterate(left)
