"""Tile pipeline: fixed-shape, mask-carrying raster tiles.

Port of ``mosaic_tpu/raster/tiles.py``. A raster streams through the
device in bounded shapes: the requested tile shape is snapped up per
axis to the bucket ladder (`dispatch/bucket.py`), edge tiles are padded,
and a boolean mask carries validity (in-bounds AND not nodata) so pad
pixels are inert in every fold.

Tile order is row-major over the tile grid and is part of the fold
contract: `raster/zonal.py` merges per-tile partials in exactly this
order, and its f64 host oracle mirrors the same decomposition.

The geotransform → pixel-center → cell-id assignment runs on the device
(:func:`tile_centers` / :func:`assign_tile_cells`) in float64, with the
same affine expression and operation order as the host's
``raster/zonal.py host_tile_centers``: every step is one correctly
rounded f64 operation on both sides, so the centers agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..dispatch.bucket import BucketLadder
from ..obs import trace as _trace
from ..runtime import telemetry as _telemetry

#: per-axis tile ladder bounds: 32 keeps toy fixtures honest (pad+mask
#: paths exercised), 2048 bounds one tile's device footprint
DEFAULT_MIN_TILE = 32
DEFAULT_MAX_TILE = 2048

#: the default tile shape when neither the caller nor the
#: ``MOSAIC_RASTER_TILE`` knob says otherwise
DEFAULT_TILE = (256, 256)


def default_tile_shape() -> tuple[int, int]:
    """The process-default tile shape: ``MOSAIC_RASTER_TILE`` ("THxTW",
    e.g. "512x512") when set, else :data:`DEFAULT_TILE`."""
    raw = os.environ.get("MOSAIC_RASTER_TILE")
    if not raw:
        return DEFAULT_TILE
    try:
        th, tw = (int(p) for p in raw.lower().split("x"))
        if th < 1 or tw < 1:
            raise ValueError(raw)
        return th, tw
    except Exception as e:
        raise ValueError(
            f"MOSAIC_RASTER_TILE must look like '256x256', got {raw!r}"
        ) from e


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The static decomposition of one raster into fixed-shape tiles.

    ``shape`` is the ladder-snapped (TH, TW) every tile dispatches at;
    ``origins`` is the (T, 2) int32 [row0, col0] table in row-major tile
    order (the fold-merge order).
    """

    shape: tuple[int, int]
    requested: tuple[int, int]
    raster_shape: tuple[int, int]  # (H, W)
    gt: tuple
    origins: np.ndarray

    @property
    def ntiles(self) -> int:
        return int(self.origins.shape[0])

    @property
    def pixels(self) -> int:
        """Real (unpadded) pixel count covered by the plan."""
        return int(self.raster_shape[0]) * int(self.raster_shape[1])

    @property
    def padded_pixels(self) -> int:
        """Pixels actually dispatched (tiles × tile area)."""
        return self.ntiles * self.shape[0] * self.shape[1]


def plan_tiles(
    raster,
    tile: "tuple[int, int] | None" = None,
    *,
    min_tile: int = DEFAULT_MIN_TILE,
    max_tile: int = DEFAULT_MAX_TILE,
) -> TilePlan:
    """Decompose ``raster`` into a row-major grid of fixed-shape tiles.

    The requested ``tile`` (default: :func:`default_tile_shape`) is
    snapped UP per axis to the bucket ladder.
    """
    th_req, tw_req = tile if tile is not None else default_tile_shape()
    ladder = BucketLadder(min_bucket=min_tile, max_bucket=max_tile, growth=2)
    h, w = int(raster.height), int(raster.width)
    th = ladder.bucket_for(min(max(th_req, 1), max_tile))
    tw = ladder.bucket_for(min(max(tw_req, 1), max_tile))
    ny = max(1, -(-h // th))
    nx = max(1, -(-w // tw))
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    origins = np.stack([iy.ravel() * th, ix.ravel() * tw], axis=1).astype(np.int32)
    return TilePlan(
        shape=(th, tw),
        requested=(int(th_req), int(tw_req)),
        raster_shape=(h, w),
        gt=tuple(raster.gt),
        origins=origins,
    )


def stack_tiles(
    raster,
    plan: TilePlan,
    band: int = 1,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """Stage one band as ((T, TH, TW) ``dtype`` values, (T, TH, TW) bool
    mask) on the host. Mask True = in-bounds AND not nodata (NaN nodata
    handled like :attr:`RasterBand.mask`); pad pixels carry value 0 and
    mask False, so they are inert in every downstream fold."""
    th, tw = plan.shape
    b = raster.band(band)
    t0 = time.perf_counter()
    with _trace.span(
        "raster.tile", ntiles=plan.ntiles, th=th, tw=tw, band=band
    ):
        vals_full = b.values
        mask_full = b.mask
        t = plan.ntiles
        vals = np.zeros((t, th, tw), dtype=dtype)
        mask = np.zeros((t, th, tw), dtype=bool)
        h, w = plan.raster_shape
        for i, (y0, x0) in enumerate(plan.origins):
            y1 = min(int(y0) + th, h)
            x1 = min(int(x0) + tw, w)
            sub = vals_full[int(y0):y1, int(x0):x1]
            vals[i, : sub.shape[0], : sub.shape[1]] = sub
            mask[i, : sub.shape[0], : sub.shape[1]] = mask_full[int(y0):y1, int(x0):x1]
        # nodata pixels contribute value 0 under a False mask (a NaN times
        # a zero mask is still NaN, so zeroing here is load-bearing)
        vals[~mask] = 0
    _telemetry.record(
        "raster_stage", stage="tile",
        seconds=round(time.perf_counter() - t0, 6),
        ntiles=t, th=th, tw=tw,
        pixels=plan.pixels, padded_pixels=plan.padded_pixels,
    )
    return vals, mask


def tile_centers(gt6, origin, *, th: int, tw: int, device=None) -> torch.Tensor:
    """((TH*TW, 2) f64) world coordinates of one tile's pixel centers,
    computed on ``device`` (default: the card) from the geotransform and
    the tile origin alone, one f64 op at a time in the host oracle's
    order."""
    dev = resolve_device(device)
    gt6 = torch.as_tensor(np.asarray(gt6, np.float64), device=dev)
    origin = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    r = torch.arange(th, dtype=torch.float64, device=dev)[:, None] + origin[0] + 0.5
    c = torch.arange(tw, dtype=torch.float64, device=dev)[None, :] + origin[1] + 0.5
    x = gt6[0] + c * gt6[1] + r * gt6[2]
    y = gt6[3] + c * gt6[4] + r * gt6[5]
    x = torch.broadcast_to(x, (th, tw)).reshape(-1)
    y = torch.broadcast_to(y, (th, tw)).reshape(-1)
    return torch.stack([x, y], dim=-1)


def assign_tile_cells(gt, origin, shape, index_system, resolution,
                      device=None) -> torch.Tensor:
    """(TH*TW,) int64 cell ids of one tile's pixel centers, on the
    device, from the f64 centers."""
    th, tw = shape
    xy = tile_centers(gt, origin, th=th, tw=tw, device=device)
    return index_system.point_to_cell(xy, resolution).to(torch.int64)
