"""Raster dataset/band model.

Port of ``mosaic_tpu/raster/core.py`` (reference analog:
`MosaicRasterGDAL` / `MosaicRasterBandGDAL`). Pixels live as one
band-sequential numpy array on the host; masks are boolean arrays
derived from the nodata tag.

File IO is not ported yet: the reference reads GeoTIFF through the
native C++ decoder (ctypes) and writes it with its own writer, and both
wait for the port's ctypes seam. :func:`read_raster` and
:func:`write_geotiff` raise :class:`RasterIONotPorted`; build a
:class:`Raster` from an in-memory array instead.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np


class RasterIONotPorted(NotImplementedError):
    """Raster file IO has not been ported yet."""


_IO_TODO = (
    "is not ported yet (ROADMAP queue 1, item 14: the ctypes seam to the "
    "native GeoTIFF decoder); build a Raster from an in-memory array"
)


@dataclasses.dataclass
class RasterBand:
    """One band view (reference: MosaicRasterBandGDAL)."""

    raster: "Raster"
    index: int  # 1-based, like GDAL

    @property
    def values(self) -> np.ndarray:
        """(H, W) pixel values."""
        return self.raster.data[self.index - 1]

    @property
    def mask(self) -> np.ndarray:
        """(H, W) bool, True = valid (nodata mask)."""
        v = self.values
        if self.raster.nodata is None:
            return np.ones(v.shape, dtype=bool)
        nodata = np.asarray(self.raster.nodata, dtype=v.dtype)
        if np.issubdtype(v.dtype, np.floating) and np.isnan(nodata):
            # v != NaN is always True — NaN nodata needs an isnan mask
            return ~np.isnan(v)
        return v != nodata

    @property
    def masked_values(self) -> np.ndarray:
        """(H, W) float64 with NaN at nodata."""
        out = self.values.astype(np.float64)
        out[~self.mask] = np.nan
        return out

    @property
    def description(self) -> str:
        return self.raster.band_metadata(self.index).get("DESCRIPTION", "")

    def min(self) -> float:
        m = self.masked_values
        return float(np.nanmin(m)) if np.isfinite(m).any() else float("nan")

    def max(self) -> float:
        m = self.masked_values
        return float(np.nanmax(m)) if np.isfinite(m).any() else float("nan")

    def mean(self) -> float:
        m = self.masked_values
        return float(np.nanmean(m)) if np.isfinite(m).any() else float("nan")


@dataclasses.dataclass
class Raster:
    """In-memory raster dataset (reference: MosaicRasterGDAL).

    data: (bands, H, W) band-sequential pixels.
    gt: GDAL-style geotransform (x0, sx, rx, y0, ry, sy).
    """

    data: np.ndarray
    gt: tuple[float, float, float, float, float, float]
    srid: int = 0
    nodata: "float | None" = None
    meta_xml: str = ""
    path: "str | None" = None
    pages: int = 1

    # ----------------------------------------------------------- metadata
    @property
    def num_bands(self) -> int:
        return int(self.data.shape[0])

    @property
    def height(self) -> int:
        return int(self.data.shape[1])

    @property
    def width(self) -> int:
        return int(self.data.shape[2])

    @property
    def memsize(self) -> int:
        return int(self.data.nbytes)

    def band(self, i: int) -> RasterBand:
        if not 1 <= i <= self.num_bands:
            raise IndexError(f"band {i} of {self.num_bands}")
        return RasterBand(self, i)

    @property
    def bands(self) -> list[RasterBand]:
        return [self.band(i) for i in range(1, self.num_bands + 1)]

    def is_empty(self) -> bool:
        """All pixels nodata / zero-sized (reference: RST_IsEmpty)."""
        if self.data.size == 0:
            return True
        if self.nodata is None:
            return False
        return bool(
            (self.data == np.asarray(self.nodata, dtype=self.data.dtype)).all()
        )

    def metadata(self) -> dict[str, str]:
        """Flattened GDAL metadata XML -> dict (reference: RST_MetaData)."""
        return _parse_gdal_meta(self.meta_xml, band=None)

    def band_metadata(self, band: int) -> dict[str, str]:
        return _parse_gdal_meta(self.meta_xml, band=band - 1)

    def subdatasets(self) -> dict[str, str]:
        """Reference: RST_Subdatasets. GeoTIFF exposes extra pages."""
        return {
            f"PAGE_{p}": f"{self.path or ''}:page{p}" for p in range(1, self.pages)
        }

    def summary(self) -> dict:
        """Reference: RST_Summary — gdalinfo-like dict."""
        return {
            "path": self.path,
            "size": [self.width, self.height],
            "bands": self.num_bands,
            "dtype": str(self.data.dtype),
            "geotransform": list(self.gt),
            "srid": self.srid,
            "nodata": self.nodata,
            "metadata": self.metadata(),
        }

    # ------------------------------------------------------ georeference
    def georeference(self) -> dict[str, float]:
        """Reference: RST_GeoReference."""
        x0, sx, rx, y0, ry, sy = self.gt
        return {
            "upperLeftX": x0, "upperLeftY": y0,
            "scaleX": sx, "scaleY": sy,
            "skewX": rx, "skewY": ry,
        }

    def world_to_raster(self, x, y):
        """World -> fractional pixel (col, row) (inverse geotransform)."""
        x0, sx, rx, y0, ry, sy = self.gt
        det = sx * sy - rx * ry
        dx = np.asarray(x, dtype=np.float64) - x0
        dy = np.asarray(y, dtype=np.float64) - y0
        col = (sy * dx - rx * dy) / det
        row = (-ry * dx + sx * dy) / det
        return col, row

    def raster_to_world(self, col, row):
        x0, sx, rx, y0, ry, sy = self.gt
        c = np.asarray(col, dtype=np.float64)
        r = np.asarray(row, dtype=np.float64)
        return x0 + c * sx + r * rx, y0 + c * ry + r * sy

    def pixel_centers(self):
        """((H*W,) x, (H*W,) y) world coordinates of all pixel centers."""
        cols, rows = np.meshgrid(np.arange(self.width), np.arange(self.height))
        return self.raster_to_world(cols.ravel() + 0.5, rows.ravel() + 0.5)

    # ------------------------------------------------------------- retile
    def retile(self, tile_w: int, tile_h: int) -> "list[Raster]":
        """Split into edge-cropped tiles (reference: RST_ReTile)."""
        out = []
        _, sx, rx, _, ry, sy = self.gt
        for y0 in range(0, self.height, tile_h):
            for x0 in range(0, self.width, tile_w):
                sub = self.data[:, y0 : y0 + tile_h, x0 : x0 + tile_w]
                wx, wy = self.raster_to_world(x0, y0)
                out.append(
                    Raster(
                        data=sub.copy(),
                        gt=(float(wx), sx, rx, float(wy), ry, sy),
                        srid=self.srid,
                        nodata=self.nodata,
                        meta_xml=self.meta_xml,
                        path=self.path,
                    )
                )
        return out

    # -------------------------------------------------------- checkpoint
    def save_checkpoint(self, directory: str, name: "str | None" = None) -> str:
        """Write a GeoTiff into the checkpoint dir — needs
        :func:`write_geotiff`, which is not ported yet."""
        if name is None:
            stem = Path(self.path).stem if self.path else "raster"
            name = f"{stem}_{abs(hash((self.gt, self.data.shape))) % 10**8}.tif"
        target = Path(directory) / name
        write_geotiff(str(target), self)
        return str(target)


def _parse_gdal_meta(xml: str, band: "int | None") -> dict[str, str]:
    """Parse GDAL's metadata XML (<Item name=.. sample=..>value</Item>).

    sample attribute = 0-based band; items without sample are dataset-level.
    """
    out: dict[str, str] = {}
    if not xml:
        return out
    for m in re.finditer(r"<Item\s+([^>]*)>(.*?)</Item>", xml, re.S):
        attrs = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        val = m.group(2).strip()
        sample = attrs.get("sample")
        if band is None and sample is None:
            out[attrs.get("name", "?")] = val
        elif band is not None and sample is not None and int(sample) == band:
            out[attrs.get("name", "?")] = val
    return out


def read_raster(path: str) -> Raster:
    """Decode a raster file. Not ported yet: raises
    :class:`RasterIONotPorted`."""
    raise RasterIONotPorted(f"read_raster({path!r}) {_IO_TODO}")


def write_geotiff(path: str, raster: Raster) -> None:
    """Write a GeoTIFF. Not ported yet: raises :class:`RasterIONotPorted`."""
    raise RasterIONotPorted(f"write_geotiff({path!r}) {_IO_TODO}")
