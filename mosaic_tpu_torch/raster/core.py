"""Raster dataset/band model + native GeoTIFF IO.

Port of ``mosaic_tpu/raster/core.py`` (reference analog:
`MosaicRasterGDAL` / `MosaicRasterBandGDAL`). Pixels live as one
band-sequential numpy array on the host; masks are boolean arrays
derived from the nodata tag.

IO: reading goes through the native decoder (`native/src/tiff.cpp`,
ctypes over the port's own `core/geometry/hostops.lib`, which builds
``native/build/libmosaicgeom.so`` with ``make`` on first use); writing
emits minimal uncompressed GeoTIFF, byte for byte the reference's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import struct
from pathlib import Path

import numpy as np

from ..core.geometry.hostops import lib as _geomlib

_DTYPES = {
    1: np.uint8, 2: np.uint16, 3: np.uint32,
    4: np.int8, 5: np.int16, 6: np.int32,
    7: np.float32, 8: np.float64,
}

_tiff_ready = False


def _lib() -> ctypes.CDLL:
    """The shared native library (geometry + tiff live in one .so)."""
    global _tiff_ready
    l = _geomlib()
    if not _tiff_ready:
        l.mg_tiff_read.restype = ctypes.c_int
        l.mg_tiff_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_char_p),
        ]
        l.mg_tiff_free.restype = None
        l.mg_tiff_free.argtypes = [ctypes.c_void_p]
        _tiff_ready = True
    return l


@dataclasses.dataclass
class RasterBand:
    """One band view (reference: MosaicRasterBandGDAL)."""

    raster: "Raster"
    index: int  # 1-based, like GDAL

    @property
    def values(self) -> np.ndarray:
        """(H, W) pixel values (`MosaicRasterBandGDAL.values:75`)."""
        return self.raster.data[self.index - 1]

    @property
    def mask(self) -> np.ndarray:
        """(H, W) bool, True = valid (nodata mask, `maskValues:99`)."""
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
        out = {}
        for p in range(1, self.pages):
            key = f"PAGE_{p}"
            out[key] = f"{self.path or ''}:page{p}"
        return out

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
        """World -> fractional pixel (col, row) (reference:
        `MosaicRasterGDAL.scala:226-252` inverse geotransform)."""
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
        cols, rows = np.meshgrid(
            np.arange(self.width), np.arange(self.height)
        )
        return self.raster_to_world(cols.ravel() + 0.5, rows.ravel() + 0.5)

    # ------------------------------------------------------------- retile
    def retile(self, tile_w: int, tile_h: int) -> "list[Raster]":
        """Split into edge-cropped tiles (reference: RST_ReTile)."""
        out = []
        for y0 in range(0, self.height, tile_h):
            for x0 in range(0, self.width, tile_w):
                sub = self.data[:, y0 : y0 + tile_h, x0 : x0 + tile_w]
                wx, wy = self.raster_to_world(x0, y0)
                x0g, sx, rx, y0g, ry, sy = self.gt
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
        """Write a GeoTiff into the checkpoint dir (reference:
        `MosaicRasterGDAL.saveCheckpoint:130-161` +
        `spark...raster.checkpoint` conf)."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if name is None:
            stem = Path(self.path).stem if self.path else "raster"
            name = f"{stem}_{abs(hash((self.gt, self.data.shape))) % 10**8}.tif"
        target = d / name
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


# --------------------------------------------------------------------- IO

#: native decoder failure taxonomy (must mirror the rc codes returned by
#: `mg_tiff_read` in native/src/tiff.cpp — each early-return there has a
#: row here, so a typed RasterDecodeError always carries the native
#: meaning, not just a number)
_DECODE_ERRORS = {
    -1: "out of memory decoding pixel planes",
    -2: "not a TIFF (bad magic/byte-order header)",
    -3: "BigTIFF is not supported by the native engine",
    -4: "corrupt or truncated IFD",
    -5: "bad image dimensions",
    -6: "unsupported bit depth / sample format",
    -7: "bad strip/tile geometry",
    -8: "chunk table shorter than the image demands",
    -9: "strip/tile decode failed (compression or predictor)",
    -10: "cannot open file",
    -11: "short read (file truncated?)",
    -12: "floating-point predictor (3) is not supported",
}


def read_raster(path: str) -> Raster:
    """Decode a raster by format (reference: RasterAPI.raster /
    `MosaicRasterGDAL.readRaster:182-187`): GeoTIFF through the native
    engine, GRIB2 through the pure-host decoder.

    A nonzero native rc raises a typed
    :class:`~mosaic_tpu_torch.runtime.errors.RasterDecodeError` carrying the
    decoder's failure taxonomy; the native pixel/meta buffers are
    released on every exit path (the ``rc == 0`` branch owns two mallocs
    that must not leak even if the numpy copy throws).
    """
    from ..runtime import faults as _faults
    from ..runtime.errors import RasterDecodeError

    low = str(path).lower()
    if low.endswith((".grib", ".grib2", ".grb", ".grb2")):
        from ..readers.grib2 import read_grib2

        return read_grib2(str(path))
    if low.endswith((".nc", ".nc4")):
        from ..readers.hdf5_lite import read_netcdf

        return read_netcdf(str(path))
    _faults.maybe_fail("raster.decode")
    l = _lib()
    iinfo = (ctypes.c_int64 * 7)()
    dinfo = (ctypes.c_double * 8)()
    px = ctypes.POINTER(ctypes.c_uint8)()
    meta = ctypes.c_char_p()
    rc = l.mg_tiff_read(
        str(path).encode(), iinfo, dinfo, ctypes.byref(px), ctypes.byref(meta)
    )
    if rc != 0:
        # the native engine frees its own partial state on error paths,
        # but a defensive free here is safe (mg_tiff_free(NULL) is a
        # no-op) and keeps the invariant local: no exit leaks
        if px:
            l.mg_tiff_free(px)
        if meta.value is not None:
            l.mg_tiff_free(meta)
        why = _DECODE_ERRORS.get(rc, "unknown decoder failure")
        raise RasterDecodeError(
            f"cannot read GeoTIFF {path!r}: {why} (native rc {rc})",
            path=str(path), rc=rc,
        )
    try:
        w, h, bands, dt, has_nd, pages, _meta_len = (int(v) for v in iinfo)
        dtype = _DTYPES[dt]
        n = bands * h * w * np.dtype(dtype).itemsize
        buf = ctypes.string_at(px, n)
        data = np.frombuffer(buf, dtype=dtype).reshape(bands, h, w).copy()
        meta_xml = (
            meta.value.decode("utf-8", "replace") if meta.value else ""
        )
    finally:
        l.mg_tiff_free(px)
        if meta.value is not None:
            l.mg_tiff_free(meta)
    return Raster(
        data=data,
        gt=tuple(float(dinfo[i]) for i in range(6)),
        srid=int(dinfo[7]),
        nodata=float(dinfo[6]) if has_nd else None,
        meta_xml=meta_xml,
        path=str(path),
        pages=pages,
    )


_NP_TO_TIFF = {
    np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
    np.dtype(np.uint32): (32, 1), np.dtype(np.int8): (8, 2),
    np.dtype(np.int16): (16, 2), np.dtype(np.int32): (32, 2),
    np.dtype(np.float32): (32, 3), np.dtype(np.float64): (64, 3),
}


def write_geotiff(path: str, raster: Raster) -> None:
    """Minimal uncompressed GeoTIFF writer (planar, single strip per band
    row-block). Little-endian classic TIFF; enough for checkpoints and for
    round-trip tests of the native reader."""
    data = np.ascontiguousarray(raster.data)
    if data.dtype not in _NP_TO_TIFF:
        raise ValueError(f"unsupported dtype {data.dtype}")
    bits, fmt = _NP_TO_TIFF[data.dtype]
    bands, h, w = data.shape
    x0, sx, rx, y0, ry, sy = raster.gt

    entries: list[tuple[int, int, int, bytes]] = []  # tag, type, count, value

    def e_short(tag, *vals):
        entries.append((tag, 3, len(vals), struct.pack(f"<{len(vals)}H", *vals)))

    def e_long(tag, *vals):
        entries.append((tag, 4, len(vals), struct.pack(f"<{len(vals)}I", *vals)))

    def e_dbl(tag, *vals):
        entries.append((tag, 12, len(vals), struct.pack(f"<{len(vals)}d", *vals)))

    def e_ascii(tag, s):
        b = s.encode() + b"\0"
        entries.append((tag, 2, len(b), b))

    pixdata = data.tobytes()
    plane = h * w * data.dtype.itemsize

    e_long(256, w)
    e_long(257, h)
    e_short(258, *([bits] * bands))
    e_short(259, 1)  # uncompressed
    e_short(262, 1)  # BlackIsZero
    e_short(277, bands)
    e_long(278, h)  # one strip per plane
    e_short(284, 2)  # planar
    e_short(339, *([fmt] * bands))
    # strip offsets filled after layout; one strip per band
    e_long(273, *([0] * bands))
    e_long(279, *([plane] * bands))
    if rx == 0.0 and ry == 0.0 and sx > 0 and sy < 0:
        # north-up axis-aligned: the conventional PixelScale + Tiepoint pair
        e_dbl(33550, sx, -sy, 0.0)
        e_dbl(33922, 0.0, 0.0, 0.0, x0, y0, 0.0)
    else:
        # rotated / skewed / south-up: full ModelTransformation matrix
        e_dbl(
            34264,
            sx, rx, 0.0, x0,
            ry, sy, 0.0, y0,
            0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 1.0,
        )
    if raster.srid:
        # minimal GeoKeyDirectory: version, revision, minor, count + one key
        geographic = 4000 <= raster.srid < 5000
        key = 2048 if geographic else 3072
        model = 2 if geographic else 1
        e_short(
            34735,
            1, 1, 0, 2,
            1024, 0, 1, model,
            key, 0, 1, raster.srid,
        )
    if raster.nodata is not None:
        e_ascii(42113, repr(float(raster.nodata)))
    if raster.meta_xml:
        e_ascii(42112, raster.meta_xml)

    entries.sort(key=lambda t: t[0])
    n = len(entries)
    # layout: header(8) + IFD(2 + 12n + 4) + out-of-line values + pixel data
    ifd_off = 8
    val_off = ifd_off + 2 + 12 * n + 4
    blobs = []
    fixed = []
    for tag, typ, cnt, val in entries:
        if len(val) <= 4:
            fixed.append((tag, typ, cnt, val.ljust(4, b"\0"), None))
        else:
            fixed.append((tag, typ, cnt, None, val_off))
            blobs.append(val)
            val_off += len(val) + (len(val) & 1)
    pix_off = val_off
    # patch strip offsets (tag 273)
    out = bytearray()
    out += b"II*\0" + struct.pack("<I", ifd_off)
    out += struct.pack("<H", n)
    bi = 0
    blob_cursor = ifd_off + 2 + 12 * n + 4
    for tag, typ, cnt, inline, off in fixed:
        out += struct.pack("<HHI", tag, typ, cnt)
        if inline is not None:
            if tag == 273:
                out += struct.pack("<I", pix_off)
            else:
                out += inline
        else:
            if tag == 273:
                blobs[bi] = struct.pack(
                    f"<{bands}I", *[pix_off + plane * b for b in range(bands)]
                )
            out += struct.pack("<I", off)
            bi += 1
    out += struct.pack("<I", 0)  # no next IFD
    for b in blobs:
        out += b
        if len(b) & 1:
            out += b"\0"
    out += pixdata
    Path(path).write_bytes(bytes(out))
