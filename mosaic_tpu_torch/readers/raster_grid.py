"""raster_to_grid pipeline + raster metadata datasource.

Reference analog: `RasterAsGridReader`
(`datasource/multiread/RasterAsGridReader.scala:18-221`): binaryFile listing
-> subdataset resolve -> retile -> rst_rastertogrid<combiner> -> explode ->
group-by cell -> k-ring inverse-distance interpolation (`kRingResample:
164-181`); and `GDALFileFormat` (`datasource/GDALFileFormat.scala:94-111`)
whose fixed metadata schema becomes :func:`read_gdal_metadata`.

Port of ``mosaic_tpu/readers/raster_grid.py``. Decoding, retiling and the
CRS transform of pixel centres run on the host; each tile's cells and
fold run where ``rst_rastertogrid*`` run: on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import glob as _glob
from pathlib import Path

import numpy as np

from ..raster import read_raster


def _list_paths(path: "str | list[str]", ext: "str | None") -> list[str]:
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    p = Path(path)
    if p.is_dir():
        suffix = (ext or "").lower()
        return sorted(
            str(q)
            for q in p.iterdir()
            if q.is_file() and q.name.lower().endswith(suffix)
        )
    if any(c in str(path) for c in "*?["):
        return sorted(_glob.glob(str(path)))
    return [str(path)]


def read_gdal_metadata(path, ext: "str | None" = ".TIF") -> list[dict]:
    """Raster metadata table: one dict per file (reference: GDALFileFormat
    fixed schema — path, sizes, band count, metadata, subdatasets, srid)."""
    out = []
    for p in _list_paths(path, ext):
        r = read_raster(p)
        out.append(
            {
                "path": p,
                "ySize": r.height,
                "xSize": r.width,
                "bandCount": r.num_bands,
                "metadata": r.metadata(),
                "subdatasets": r.subdatasets(),
                "srid": r.srid,
                "proj4Str": "",
            }
        )
    return out


def raster_to_grid(
    path,
    resolution: int,
    combiner: str = "avg",
    index=None,
    raster_srid: "int | None" = None,
    tile_size: int = 512,
    k_ring_interpolate: int = 0,
    ext: "str | None" = ".TIF",
    device=None,
) -> dict[int, dict[int, float]]:
    """Full pipeline: files -> retile -> pixel->cell combine -> merge ->
    optional k-ring inverse-distance resample.

    Returns {band (1-based): {cell_id: value}} merged over all input files.
    ``device`` is passed to every ``rst_rastertogrid*`` call.
    """
    from ..context import current_context
    from ..functions import raster as RF

    if index is None:
        index = current_context().index_system
    resolution = index.resolution_arg(resolution)

    if combiner not in ("avg", "min", "max", "median", "count"):
        raise ValueError(f"unknown combiner {combiner!r}")

    # Per-cell accumulation across tiles and files (the reference's final
    # group-by(band, cell) combine, `RasterAsGridReader.scala:61-76`).
    # avg is merged pixel-weighted (sum of avg*count / sum of count) so cells
    # straddling tile boundaries combine exactly; median is not mergeable
    # from per-tile medians, so median skips retiling and runs whole-raster.
    per_band_acc: dict[int, dict[int, list]] = {}
    fn = getattr(RF, f"rst_rastertogrid{combiner}")
    for p in _list_paths(path, ext):
        r = read_raster(p)
        can_tile = combiner != "median"
        tiles = r.retile(tile_size, tile_size) if can_tile and (
            r.width > tile_size or r.height > tile_size
        ) else [r]
        for t in tiles:
            if combiner == "avg":
                # avg and count of the tile from one pass (one cell
                # assignment, one fold), as the reference's two calls give
                both = RF._raster_to_grids([t], resolution, index, ("avg", "count"),
                                           raster_srid, device)
                res, cnt = both["avg"][0], both["count"][0]
            else:
                res = fn([t], resolution, index=index, raster_srid=raster_srid,
                         device=device)[0]
            for b, cellmap in enumerate(res, start=1):
                acc = per_band_acc.setdefault(b, {})
                for cell, val in cellmap.items():
                    if combiner == "avg":
                        acc.setdefault(cell, []).append(
                            (val * cnt[b - 1][cell], cnt[b - 1][cell])
                        )
                    else:
                        acc.setdefault(cell, []).append(val)

    merged: dict[int, dict[int, float]] = {}
    for b, acc in per_band_acc.items():
        cells = {}
        for cell, vals in acc.items():
            if combiner == "avg":
                s = sum(v[0] for v in vals)
                c = sum(v[1] for v in vals)
                cells[cell] = float(s / c) if c else float("nan")
                continue
            v = np.asarray(vals, dtype=np.float64)
            if combiner == "min":
                cells[cell] = float(v.min())
            elif combiner == "max":
                cells[cell] = float(v.max())
            elif combiner == "median":
                cells[cell] = float(v[0]) if v.size == 1 else float(np.median(v))
            elif combiner == "count":
                cells[cell] = float(v.sum())
        merged[b] = cells

    if k_ring_interpolate > 0:
        for b in merged:
            merged[b] = k_ring_resample(
                merged[b], k_ring_interpolate, index
            )
    return merged


def k_ring_resample(
    cellmap: dict[int, float], k: int, index
) -> dict[int, float]:
    """Inverse-grid-distance weighted smoothing over each cell's k-ring
    (reference: `kRingResample` / `gridDistanceInverse` weighting,
    `RasterAsGridReader.scala:164-181`). Cells with no measured neighbor
    keep no value (like the reference's inner join on the ring)."""
    if not cellmap:
        return cellmap
    cells = np.fromiter(cellmap.keys(), dtype=np.int64)
    vals = np.fromiter(cellmap.values(), dtype=np.float64)
    rings = np.asarray(index.k_ring(cells, int(k)))  # (N, M)
    lut = {int(c): float(v) for c, v in zip(cells, vals)}
    out: dict[int, float] = {}
    # every ring member becomes a target; weight = 1/(1+grid_distance)
    targets: dict[int, list[tuple[float, float]]] = {}
    for i in range(cells.shape[0]):
        ring = rings[i]
        ring = ring[ring >= 0]
        dist = np.asarray(
            index.grid_distance(np.full(ring.shape, cells[i]), ring)
        ).astype(np.float64)
        w = 1.0 / (1.0 + dist)
        for c, wi in zip(ring, w):
            targets.setdefault(int(c), []).append((wi * vals[i], wi))
    for c, pairs in targets.items():
        num = sum(p[0] for p in pairs)
        den = sum(p[1] for p in pairs)
        out[c] = lut.get(c, num / den if den else np.nan)
        # measured cells keep their measurement; unmeasured get the IDW blend
    return out
