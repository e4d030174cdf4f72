"""MosaicAnalyzer: optimal grid-resolution estimation.

Port of ``mosaic_tpu/sql/analyzer.py``, host numpy as there, so its
resolutions and metrics are the reference's bit for bit. The profiler
(`tune/profiler.py profile_polygons`) reads it.

Reference analog: `sql/MosaicAnalyzer.scala:28-129` — sample the geometry
column, compare area percentiles against the mean cell area per resolution,
and pick the resolution whose cells-per-geometry ratio falls inside a target
band. `SampleStrategy` (`sql/SampleStrategy.scala:5`) becomes a plain
(fraction, limit) pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.index.base import IndexSystem
from ..functions._coerce import to_packed


@dataclasses.dataclass
class SampleStrategy:
    fraction: float = 1.0
    limit: "int | None" = None

    def __post_init__(self):
        # fraction=0 would floor every sample to the max(1, ...) clamp and
        # silently analyze a single row; out-of-range fractions are always
        # a caller bug, so fail at construction, not deep in numpy
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"SampleStrategy fraction must be in (0, 1], got "
                f"{self.fraction!r} — pass fraction=1.0 with limit=K to "
                f"sample a fixed number of rows"
            )
        if self.limit is not None and self.limit < 1:
            raise ValueError(
                f"SampleStrategy limit must be >= 1, got {self.limit!r}"
            )

    def apply(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if n <= 0:
            # without this, n=0 reaches rng.choice(0, size=1) and dies with
            # an opaque "a must be greater than 0" deep in numpy
            raise ValueError(
                "cannot sample an empty geometry column (0 rows) — the "
                "analyzer needs at least one geometry; check the upstream "
                "filter or load"
            )
        take = int(np.ceil(n * self.fraction))
        if self.limit is not None:
            take = min(take, self.limit)
        take = max(1, min(take, n))
        return rng.choice(n, size=take, replace=False)


class MosaicAnalyzer:
    """Pick the resolution where a typical geometry spans ``target_cells``
    grid cells (the reference defaults to ~16-256 cells per geometry)."""

    def __init__(self, index: IndexSystem, target_cells: float = 64.0):
        self.index = index
        self.target_cells = target_cells

    def _sampled(self, col, sample: SampleStrategy, seed: int):
        """(sampled PackedGeometry, finite positive areas) — the shared
        sampling/area/filter step of every analyzer entry point."""
        packed = to_packed(col)
        rng = np.random.default_rng(seed)
        rows = sample.apply(len(packed), rng)
        from ..core.geometry import oracle

        sub = packed.take(rows)
        areas = oracle.area(sub)
        areas = areas[np.isfinite(areas) & (areas > 0)]
        if areas.size == 0:
            raise ValueError("no polygonal geometries to analyze")
        return sub, areas

    def _geometry_areas(self, col, sample: SampleStrategy, seed: int) -> np.ndarray:
        return self._sampled(col, sample, seed)[1]

    def get_optimal_resolution(
        self,
        col,
        sample: "SampleStrategy | None" = None,
        percentile: float = 50.0,
        seed: int = 0,
    ) -> int:
        """Resolution whose mean cell area is closest to
        geometry_area(percentile) / target_cells
        (reference: `getOptimalResolution:28-39`)."""
        sample = sample or SampleStrategy()
        areas = self._geometry_areas(col, sample, seed)
        target_cell_area = np.percentile(areas, percentile) / self.target_cells
        best, best_err = None, np.inf
        for res in self.index.resolutions():
            try:
                ca = self.index.cell_area_approx(res)
            except NotImplementedError:
                continue
            err = abs(np.log(ca / target_cell_area))
            if err < best_err:
                best, best_err = res, err
        if best is None:
            raise ValueError("index system exposes no cell areas")
        return int(best)

    def get_optimal_resolution_reference(
        self,
        col,
        sample: "SampleStrategy | None" = None,
        lower: float = 1.0,
        upper: float = 100.0,
        seed: int = 0,
    ) -> int:
        """The reference's exact recipe (`MosaicAnalyzer.scala:28-39` +
        `:41-100`): per resolution, the mean cell area is measured from
        the boundary polygon of the cell containing each geometry's
        centroid; resolutions where ANY of the mean/p25/p50/p75
        cells-per-geometry ratios fall inside (lower, upper) survive, and
        the median-by-p50-ratio row wins. Golden-pinned on the NYC taxi
        fixture in tests/test_models_services.py (resolution 9)."""
        sample = sample or SampleStrategy()
        sub, areas = self._sampled(col, sample, seed)
        from ..core.geometry import oracle

        stats = (
            float(areas.mean()),
            *(float(v) for v in np.percentile(areas, [25, 50, 75])),
        )
        cents = oracle.centroid(sub)
        cents = cents[np.isfinite(cents).all(axis=1)]
        kept: list[tuple[float, int]] = []
        for res in self.index.resolutions():
            cells = np.asarray(self.index.point_to_cell(cents, res))
            bnd = np.asarray(self.index.cell_boundary(cells))
            x, y = bnd[..., 0], bnd[..., 1]
            a = 0.5 * np.abs(
                np.sum(
                    x * np.roll(y, -1, axis=-1) - np.roll(x, -1, axis=-1) * y,
                    axis=-1,
                )
            )
            ia = float(a.mean())
            if ia <= 0:
                continue
            ratios = [s / ia for s in stats]
            if any(lower < r < upper for r in ratios):
                kept.append((ratios[2], int(res)))
        if not kept:
            raise ValueError(
                "no resolution has cells-per-geometry inside "
                f"({lower}, {upper})"
            )
        kept.sort()
        return kept[(len(kept) - 1) // 2][1]

    def get_resolution_metrics(
        self,
        col,
        sample: "SampleStrategy | None" = None,
        seed: int = 0,
    ) -> dict[int, dict[str, float]]:
        """Per-resolution cells-per-geometry percentiles (reference:
        `getResolutionMetrics:41-100`)."""
        sample = sample or SampleStrategy()
        areas = self._geometry_areas(col, sample, seed)
        out: dict[int, dict[str, float]] = {}
        for res in self.index.resolutions():
            try:
                ca = self.index.cell_area_approx(res)
            except NotImplementedError:
                continue
            ratio = areas / ca
            out[int(res)] = {
                "mean_cells": float(ratio.mean()),
                "p25_cells": float(np.percentile(ratio, 25)),
                "p50_cells": float(np.percentile(ratio, 50)),
                "p75_cells": float(np.percentile(ratio, 75)),
            }
        return out
