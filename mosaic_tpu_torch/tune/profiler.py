"""Workload profiling: sample a workload into a typed `WorkloadProfile`.

Port of ``mosaic_tpu/tune/profiler.py``. The statistics are host numpy
on the same capped sample, so a profile equals the reference's bit for
bit. An index on the card is read once per call: each table the profile
reads (``cells``, ``cell_heavy``, ``cell_convex``, ``chip_rows``) is
copied to the host whole, never element by element; the band fraction
reads the index's f64 `HostRecheck` twin, which lives on the host.

The profile is the optimizer's input contract — the same statistics the
bench ``detail`` blocks already collect (`bench.py caps_for` presample,
`tools/raster_bench.py` occupancy), computed once on a capped host-side
sample and recorded under a ``tune.profile`` span so profiling shows up in
trails like any other stage:

- **match rate / class shares** — fraction of sampled points whose cell is
  in the index, split light/heavy/convex by the index's own density
  classes (``cell_heavy`` / ``cell_convex``), because the shares decide
  probe-lane routing.
- **chip-density histogram** — chips-per-cell percentiles over the cells
  the sample actually hits; dense cells push toward the adaptive probe.
- **epsilon-band fraction** — fraction of matched sample points within
  ``EDGE_BAND_K * eps(f32) * coord_scale`` of a chip edge (the exact
  recheck band, computed against the f64 `HostRecheck` companion); high
  band fractions mean recheck cost dominates and finer resolutions pay.
- **cells-per-geometry percentiles** — `sql.analyzer.MosaicAnalyzer`'s
  metrics at its recommended resolution (polygon workloads).
- **tile occupancy / nodata fraction** — valid-pixel share per
  `raster.tiles.stack_tiles` mask (raster workloads); sparse tiles favor
  smaller tile shapes so empty tiles are skipped, not padded.

Everything here is host-side numpy on a deterministic capped sample —
no kernel runs and nothing is built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.checkpoint import host_array as _host

#: deterministic profiling sample cap — large enough for stable shares
#: (binomial std < 1% at 4096), small enough that the f64 edge-distance
#: scan stays in the milliseconds
DEFAULT_SAMPLE = 4096


@dataclasses.dataclass
class WorkloadProfile:
    """One workload, summarized. ``kind`` is ``points`` / ``polygons`` /
    ``raster``; fields that a given kind does not measure stay None."""

    kind: str
    n_sampled: int
    n_total: "int | None" = None  # full workload size (sampling excluded)
    resolution: "int | None" = None  # resolution the sample was probed at
    match_rate: "float | None" = None
    class_shares: "dict | None" = None  # {"light","heavy","convex"} of matches
    chip_density: "dict | None" = None  # chips-per-cell p50/p90/max over hit cells
    band_fraction: "float | None" = None
    cells_per_geom: "dict | None" = None  # analyzer mean/p25/p50/p75
    optimal_resolution: "int | None" = None
    tile_occupancy: "float | None" = None
    nodata_fraction: "float | None" = None
    sure_fraction: "float | None" = None  # overlay pairs decided core-free
    border_fraction: "float | None" = None  # overlay pairs paying the predicate

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadProfile":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _sample_rows(n: int, sample: int, seed: int) -> np.ndarray:
    if n <= sample:
        return np.arange(n)
    return np.random.default_rng(seed).choice(n, size=sample, replace=False)


def _seg_dist2(px, py, edges):
    """(n,) min squared point-to-segment distance over (n, E, 4) f64
    edges; zero-padded edge rows are masked out."""
    ax, ay, bx, by = (edges[..., i] for i in range(4))
    live = (np.abs(edges).sum(axis=-1) > 0.0)
    dx, dy = bx - ax, by - ay
    den = np.maximum(dx * dx + dy * dy, 1e-300)
    t = np.clip(((px[:, None] - ax) * dx + (py[:, None] - ay) * dy) / den, 0.0, 1.0)
    qx, qy = ax + t * dx - px[:, None], ay + t * dy - py[:, None]
    d2 = qx * qx + qy * qy
    return np.where(live, d2, np.inf).min(axis=1)


def profile_points(
    points,
    chip_index,
    index_system,
    resolution: int,
    *,
    sample: int = DEFAULT_SAMPLE,
    seed: int = 0,
) -> WorkloadProfile:
    """Profile a point workload against a resident index: match rate,
    light/heavy/convex shares, chip-density histogram of the hit cells,
    and the epsilon-band fraction (when the index carries its f64 host
    companion)."""
    from ..sql.join import EDGE_BAND_K

    raw = np.asarray(_host(points), dtype=np.float64)
    with _trace.span(
        "tune.profile", kind="points", n=int(raw.shape[0]), sample=sample
    ), _telemetry.timed("tune_stage", stage="profile", kind="points"):
        rows = _sample_rows(raw.shape[0], sample, seed)
        pts = raw[rows]
        cells = np.asarray(
            index_system.point_to_cell(pts, resolution)
        ).astype(np.int64)
        index_cells = _host(chip_index.cells)
        U = index_cells.shape[0]
        if U:
            u = np.clip(np.searchsorted(index_cells, cells), 0, U - 1)
            matched = index_cells[u] == cells
        else:
            u = np.zeros(pts.shape[0], dtype=np.int64)
            matched = np.zeros(pts.shape[0], dtype=bool)
        n = max(1, pts.shape[0])
        match_rate = float(matched.sum()) / n
        um = u[matched]
        heavy = _host(chip_index.cell_heavy)[um] >= 0
        convex = _host(chip_index.cell_convex)[um] >= 0
        m = max(1, int(matched.sum()))
        shares = {
            "heavy": float(heavy.sum()) / m,
            "convex": float(convex.sum()) / m,
            "light": float((~heavy & ~convex).sum()) / m,
        }
        # chip_rows keeps every chip of every cell (heavy cells divert
        # their chips OUT of cell_slot_geom, which would undercount)
        chip_rows = _host(chip_index.chip_rows)
        chips = (chip_rows[um] >= 0).sum(axis=1) if um.size else np.zeros(0)
        density = {
            "p50": float(np.percentile(chips, 50)) if chips.size else 0.0,
            "p90": float(np.percentile(chips, 90)) if chips.size else 0.0,
            "max": float(chips.max()) if chips.size else 0.0,
        }
        host = getattr(chip_index, "host", None)
        band_fraction = None
        if host is not None and matched.any():
            p = pts[matched] - host.shift
            d2 = _seg_dist2(p[:, 0], p[:, 1], host.cell_edges[um])
            thr = EDGE_BAND_K * float(np.finfo(np.float32).eps) * host.coord_scale
            band_fraction = float((d2 < thr * thr).sum()) / m
        prof = WorkloadProfile(
            kind="points",
            n_sampled=int(pts.shape[0]),
            n_total=int(raw.shape[0]),
            resolution=int(resolution),
            match_rate=match_rate,
            class_shares=shares,
            chip_density=density,
            band_fraction=band_fraction,
        )
        _telemetry.record("tune_profile", **_flat(prof))
        return prof


def profile_polygons(
    polygons,
    index_system,
    *,
    target_cells: float = 64.0,
    fraction: float = 1.0,
    limit: "int | None" = None,
) -> WorkloadProfile:
    """Profile a polygon set with `sql.analyzer.MosaicAnalyzer`: the
    data-driven resolution plus cells-per-geometry percentiles at that
    resolution."""
    from ..functions._coerce import to_packed
    from ..sql.analyzer import MosaicAnalyzer, SampleStrategy

    packed = to_packed(polygons)
    with _trace.span(
        "tune.profile", kind="polygons", n=len(packed)
    ), _telemetry.timed("tune_stage", stage="profile", kind="polygons"):
        analyzer = MosaicAnalyzer(index_system, target_cells=target_cells)
        strategy = SampleStrategy(fraction=fraction, limit=limit)
        res = analyzer.get_optimal_resolution(packed, strategy)
        at = analyzer.get_resolution_metrics(packed, strategy).get(res, {})
        prof = WorkloadProfile(
            kind="polygons",
            n_sampled=len(packed),
            n_total=len(packed),
            optimal_resolution=int(res),
            # analyzer keys are "<stat>_cells"; store the bare stat names
            cells_per_geom={
                k.rsplit("_", 1)[0]: float(v) for k, v in at.items()
            } or None,
        )
        _telemetry.record("tune_profile", **_flat(prof))
        return prof


def profile_overlay(
    left,
    right,
    index_system,
    resolution: int,
    *,
    left_chips=None,
    right_chips=None,
) -> WorkloadProfile:
    """Profile a polygon-polygon overlay join by CONSUMING the statistics
    `sql.overlay.candidate_pairs` already emits on its
    ``overlay.candidates`` span: the candidate count, the sure-fraction
    (pairs a core chip decides predicate-free), and the border-fraction
    (pairs that pay the exact ``st_intersects`` predicate). Border-heavy
    overlays are predicate-bound, and the recommender turns that into a
    finer-tessellation recommendation (`recommend.OVERLAY_BORDER_SHARE`).

    Pass prebuilt chip tables to amortize tessellation, exactly as
    `intersects_join` does."""
    from ..core.tessellate import tessellate
    from ..sql.overlay import candidate_pairs

    with _trace.span(
        "tune.profile", kind="overlay", resolution=int(resolution)
    ), _telemetry.timed("tune_stage", stage="profile", kind="overlay"):
        lt = (
            left_chips
            if left_chips is not None
            else tessellate(left, index_system, resolution)
        )
        rt = (
            right_chips
            if right_chips is not None
            else tessellate(right, index_system, resolution)
        )
        with _telemetry.capture() as events:
            candidate_pairs(lt, rt)
        stats = next(
            e for e in reversed(events)
            if e.get("event") == "overlay_candidates"
        )
        prof = WorkloadProfile(
            kind="overlay",
            n_sampled=int(stats["candidates"]),
            n_total=int(stats["candidates"]),
            resolution=int(resolution),
            sure_fraction=float(stats["sure_fraction"]),
            border_fraction=float(stats["border_fraction"]),
        )
        _telemetry.record("tune_profile", **_flat(prof))
        return prof


def profile_raster(
    raster,
    *,
    band: int = 1,
    tile: "tuple[int, int] | None" = None,
) -> WorkloadProfile:
    """Profile a raster: tile occupancy (mean valid-pixel share per tile)
    and the overall nodata fraction, from the same `stack_tiles` mask the
    zonal fold uses."""
    from ..raster.tiles import plan_tiles, stack_tiles

    with _trace.span(
        "tune.profile", kind="raster", band=int(band)
    ), _telemetry.timed("tune_stage", stage="profile", kind="raster"):
        plan = plan_tiles(raster, tile)
        _, mask = stack_tiles(raster, plan, band=band)
        per_tile = mask.reshape(mask.shape[0], -1).mean(axis=1)
        bm = raster.band(band).mask
        prof = WorkloadProfile(
            kind="raster",
            n_sampled=int(mask.shape[0]),
            n_total=int(mask.shape[0]),
            tile_occupancy=float(per_tile.mean()) if per_tile.size else 0.0,
            nodata_fraction=float(1.0 - bm.mean()) if bm.size else 1.0,
        )
        _telemetry.record("tune_profile", **_flat(prof))
        return prof


def _flat(prof: WorkloadProfile) -> dict:
    """Profile as flat telemetry fields (nested dicts stay readable)."""
    out = {}
    for k, v in prof.as_dict().items():
        if isinstance(v, dict):
            out.update({f"{k}_{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out
