"""RST_ raster functions.

Port of ``mosaic_tpu/functions/raster.py`` on in-memory rasters.
Reference analog: the 32 raster expressions under `expressions/raster/`
(metadata + georeference accessors, world<->raster coordinate transforms,
`RST_ReTile` generator, and the five `RST_RasterToGrid{Avg,Min,Max,Median,
Count}` projections whose per-pixel JVM callback loop
(`expressions/raster/base/RasterToGridExpression.scala:55-92`) becomes a
few device ops here: affine pixel->world on the host, `point_to_cell` on
the device, and the fold by cell on the device through
`kernels/zonal.py zonal_fold_masked` (the hand-written ``zonal_seq_fold``
on the card: count, sum in pixel order, min and max a cell, where the
reference uses ``jax.ops.segment_*``). The median sorts on the host, as
in the reference. The projections run on the card unless the caller
passes ``device="cpu"``.

Raster columns are lists of :class:`~mosaic_tpu_torch.raster.Raster` or
paths, which are read with `read_raster`. A raster whose SRID is not the
index's has its pixel centres reprojected on the host (``core/crs.py``,
the numpy lane) before the cells are assigned on the device.
"""

from __future__ import annotations

import numpy as np

from ..core.index.base import IndexSystem
from ..raster import Raster, read_raster

__all__ = [
    "rst_metadata", "rst_bandmetadata", "rst_georeference", "rst_height",
    "rst_width", "rst_numbands", "rst_srid", "rst_memsize", "rst_isempty",
    "rst_subdatasets", "rst_summary", "rst_scalex", "rst_scaley",
    "rst_skewx", "rst_skewy", "rst_upperleftx", "rst_upperlefty",
    "rst_pixelwidth", "rst_pixelheight", "rst_rotation",
    "rst_rastertoworldcoord", "rst_rastertoworldcoordx",
    "rst_rastertoworldcoordy", "rst_worldtorastercoord",
    "rst_worldtorastercoordx", "rst_worldtorastercoordy", "rst_retile",
    "rst_rastertogridavg", "rst_rastertogridmin", "rst_rastertogridmax",
    "rst_rastertogridmedian", "rst_rastertogridcount",
    "rst_mapbands", "rst_ndvi",
]


def _rasters(col) -> list[Raster]:
    if isinstance(col, Raster):
        return [col]
    if isinstance(col, (str,)):
        return [read_raster(col)]
    return [r if isinstance(r, Raster) else read_raster(r) for r in col]


# ------------------------------------------------------------- metadata


def rst_metadata(col) -> list[dict]:
    return [r.metadata() for r in _rasters(col)]


def rst_bandmetadata(col, band: int) -> list[dict]:
    return [r.band_metadata(band) for r in _rasters(col)]


def rst_georeference(col) -> list[dict]:
    return [r.georeference() for r in _rasters(col)]


def rst_height(col) -> np.ndarray:
    return np.array([r.height for r in _rasters(col)], dtype=np.int64)


def rst_width(col) -> np.ndarray:
    return np.array([r.width for r in _rasters(col)], dtype=np.int64)


def rst_numbands(col) -> np.ndarray:
    return np.array([r.num_bands for r in _rasters(col)], dtype=np.int64)


def rst_srid(col) -> np.ndarray:
    return np.array([r.srid for r in _rasters(col)], dtype=np.int64)


def rst_memsize(col) -> np.ndarray:
    return np.array([r.memsize for r in _rasters(col)], dtype=np.int64)


def rst_isempty(col) -> np.ndarray:
    return np.array([r.is_empty() for r in _rasters(col)], dtype=bool)


def rst_subdatasets(col) -> list[dict]:
    return [r.subdatasets() for r in _rasters(col)]


def rst_summary(col) -> list[dict]:
    return [r.summary() for r in _rasters(col)]


def _gt(col, i: int) -> np.ndarray:
    return np.array([r.gt[i] for r in _rasters(col)], dtype=np.float64)


def rst_upperleftx(col) -> np.ndarray:
    return _gt(col, 0)


def rst_scalex(col) -> np.ndarray:
    return _gt(col, 1)


def rst_skewx(col) -> np.ndarray:
    return _gt(col, 2)


def rst_upperlefty(col) -> np.ndarray:
    return _gt(col, 3)


def rst_skewy(col) -> np.ndarray:
    return _gt(col, 4)


def rst_scaley(col) -> np.ndarray:
    return _gt(col, 5)


def rst_pixelwidth(col) -> np.ndarray:
    """Ground width of a pixel incl. skew (reference: RST_PixelWidth)."""
    return np.hypot(_gt(col, 1), _gt(col, 4))


def rst_pixelheight(col) -> np.ndarray:
    return np.hypot(_gt(col, 5), _gt(col, 2))


def rst_rotation(col) -> np.ndarray:
    """Rotation angle (radians) of the raster grid vs north-up
    (reference: RST_Rotation)."""
    return np.arctan2(_gt(col, 4), _gt(col, 1))


# --------------------------------------------------- coordinate transforms


def rst_rastertoworldcoord(col, x, y) -> np.ndarray:
    """(N, 2) world coords of pixel (x, y) per raster."""
    out = [r.raster_to_world(x, y) for r in _rasters(col)]
    return np.array(out, dtype=np.float64)


def rst_rastertoworldcoordx(col, x, y) -> np.ndarray:
    return rst_rastertoworldcoord(col, x, y)[:, 0]


def rst_rastertoworldcoordy(col, x, y) -> np.ndarray:
    return rst_rastertoworldcoord(col, x, y)[:, 1]


def rst_worldtorastercoord(col, x, y) -> np.ndarray:
    """(N, 2) int pixel coords of world point (x, y) per raster."""
    out = []
    for r in _rasters(col):
        c, rr = r.world_to_raster(x, y)
        out.append((int(np.floor(c)), int(np.floor(rr))))
    return np.array(out, dtype=np.int64)


def rst_worldtorastercoordx(col, x, y) -> np.ndarray:
    return rst_worldtorastercoord(col, x, y)[:, 0]


def rst_worldtorastercoordy(col, x, y) -> np.ndarray:
    return rst_worldtorastercoord(col, x, y)[:, 1]


# ----------------------------------------------------------------- retile


def rst_retile(col, tile_width: int, tile_height: int) -> list[Raster]:
    """Explode rasters into tiles (reference: RST_ReTile generator)."""
    out: list[Raster] = []
    for r in _rasters(col):
        out.extend(r.retile(tile_width, tile_height))
    return out


# --------------------------------------------------------- raster -> grid


def _pixel_cells(
    r: Raster, resolution: int, index: IndexSystem, raster_srid: "int | None",
    dev,
):
    """(P,) int64 cell id of every pixel center, on ``dev``."""
    import torch

    from ..core import crs as _crs

    x, y = r.pixel_centers()
    srid = raster_srid if raster_srid is not None else (r.srid or 4326)
    xy = np.stack([x, y], axis=-1)
    target = getattr(index, "crs_srid", 4326)
    if target and srid != target:
        if not _crs.supported(srid):
            raise ValueError(
                f"raster SRID {srid} cannot be transformed to the index "
                f"CRS (EPSG:{target}); pass raster_srid explicitly or use "
                f"a CUSTOM index in the raster's own CRS"
            )
        xy = _crs.transform_points(xy, srid, target)
    cells = index.point_to_cell(torch.as_tensor(xy.reshape(-1, 2), device=dev),
                                resolution)
    return torch.as_tensor(cells, device=dev).reshape(-1)


def _raster_to_grid(col, resolution, index, combiner: str, raster_srid=None,
                    device=None):
    """Shared pixel->cell group-combine (reference:
    `RasterToGridExpression.rasterTransform:55-72`): returns per raster a
    list (per band) of dicts cell_id -> combined value, over the cells
    holding at least one valid pixel."""
    return _raster_to_grids(col, resolution, index, (combiner,), raster_srid,
                            device)[combiner]


def _raster_to_grids(col, resolution, index, combiners, raster_srid=None,
                     device=None) -> dict:
    """:func:`_raster_to_grid` for several combiners from one pass: the
    pixel cells are assigned once a raster and folded once a band, so a
    reader that needs avg and count of a tile pays for one.

    avg/count/min/max fold on the device (`zonal_fold_masked`, f64:
    count, the sequential sum in pixel order, min and max of the valid
    pixels of each cell); median sorts on the host."""
    import torch

    from .. import resolve_device
    from ..kernels.zonal import zonal_fold_masked

    for combiner in combiners:
        if combiner not in ("avg", "count", "min", "max", "median"):
            raise ValueError(f"unknown combiner {combiner!r}")
    if index is None:
        from ..context import current_context

        index = current_context().index_system
    resolution = index.resolution_arg(resolution)
    dev = resolve_device(device)
    results = {c: [] for c in combiners}
    for r in _rasters(col):
        cells = _pixel_cells(r, resolution, index, raster_srid, dev)
        uniq_t, inv_t = torch.unique(cells, sorted=True, return_inverse=True)
        uniq = uniq_t.cpu().numpy()
        nseg = int(uniq.size)
        inv = None
        per_band = {c: [] for c in combiners}
        for b in r.bands:
            vals = b.values.ravel().astype(np.float64)
            mask = b.mask.ravel()
            outs = {}
            if "median" in combiners:
                if inv is None:
                    inv = inv_t.cpu().numpy()
                out = np.full(nseg, np.nan)
                order = np.argsort(inv, kind="stable")
                sorted_vals = vals[order]
                sorted_mask = mask[order]
                bounds = np.searchsorted(inv[order], np.arange(nseg + 1))
                for s in range(nseg):
                    seg = sorted_vals[bounds[s] : bounds[s + 1]]
                    msk = sorted_mask[bounds[s] : bounds[s + 1]]
                    seg = seg[msk]
                    out[s] = np.median(seg) if seg.size else np.nan
                outs["median"] = (out, np.bincount(inv[mask], minlength=nseg) > 0)
            folded = [c for c in combiners if c != "median"]
            if folded:
                cnt, s, mn, mx = zonal_fold_masked(
                    torch.as_tensor(vals, device=dev),
                    torch.as_tensor(mask, device=dev), inv_t, nseg,
                    acc_dtype=torch.float64,
                )
                cnt = cnt.cpu().numpy().astype(np.float64)
                keep = cnt > 0
                for combiner in folded:
                    if combiner == "count":
                        out = cnt
                    elif combiner == "avg":
                        out = s.cpu().numpy() / np.maximum(cnt, 1.0)
                    elif combiner == "min":
                        out = mn.cpu().numpy()
                    else:
                        out = mx.cpu().numpy()
                    outs[combiner] = (out, keep)
            for combiner, (out, keep) in outs.items():
                per_band[combiner].append(
                    {int(c): float(o) for c, o, k in zip(uniq, out, keep) if k}
                )
        for combiner in combiners:
            results[combiner].append(per_band[combiner])
    return results


def rst_rastertogridavg(col, resolution, index=None, raster_srid=None,
                        device=None):
    return _raster_to_grid(col, resolution, index, "avg", raster_srid,
                           device)


def rst_rastertogridmin(col, resolution, index=None, raster_srid=None,
                        device=None):
    return _raster_to_grid(col, resolution, index, "min", raster_srid,
                           device)


def rst_rastertogridmax(col, resolution, index=None, raster_srid=None,
                        device=None):
    return _raster_to_grid(col, resolution, index, "max", raster_srid,
                           device)


def rst_rastertogridmedian(col, resolution, index=None, raster_srid=None,
                        device=None):
    return _raster_to_grid(col, resolution, index, "median", raster_srid,
                           device)


def rst_rastertogridcount(col, resolution, index=None, raster_srid=None,
                        device=None):
    return _raster_to_grid(col, resolution, index, "count", raster_srid,
                           device)


# ------------------------------------------------------- expression layer


def rst_mapbands(col, expr, tile=None, index=None,
                 resolution=None, device=None) -> list[Raster]:
    """Evaluate a per-pixel expression tree (`mosaic_tpu_torch.expr`)
    over each raster: one fused program per tile bucket runs the whole
    band-math pipeline, on the card unless ``device="cpu"``. Returns single-band f64
    rasters (same geotransform/SRID) with NaN nodata at invalid pixels —
    invalid means outside the pad∧nodata∧NaN tile mask or masked by the
    expression's own ``mask_where``. Trees using ``cell_of()`` need a
    resolution (and an index — the context's by default)."""
    from ..expr import map_pixels
    from ..expr.ast import uses_cells

    index_system = None
    if uses_cells(expr):
        if index is None:
            from ..context import current_context

            index = current_context().index_system
        if resolution is None:
            raise ValueError(
                "rst_mapbands: cell_of() trees need an explicit "
                "resolution"
            )
        index_system = index
        resolution = index.resolution_arg(resolution)
    out: list[Raster] = []
    for r in _rasters(col):
        vals, _valid = map_pixels(
            expr, r, tile=tile,
            index_system=index_system, resolution=resolution, device=device,
        )
        out.append(
            Raster(
                data=vals[None, :, :],
                gt=tuple(r.gt),
                srid=r.srid,
                nodata=float("nan"),
            )
        )
    return out


def rst_ndvi(col, nir_band: int = 2, red_band: int = 1,
             tile=None, device=None) -> list[Raster]:
    """NDVI ``(nir - red) / (nir + red)`` per raster as a fused
    expression program (reference: RST_NDVI); pixels invalid in either
    band come out NaN-nodata."""
    from ..expr import ndvi

    return rst_mapbands(col, ndvi(nir=nir_band, red=red_band), tile=tile,
                        device=device)
