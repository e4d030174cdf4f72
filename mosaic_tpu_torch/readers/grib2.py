"""GRIB raster reader (editions 1 and 2; pure host decode, no GDAL).

Reference analog: GDAL's GRIB driver behind `MosaicRasterGDAL.readRaster`
(`core/raster/MosaicRasterGDAL.scala:182-187`; the reference's
`binary/grib-cams` fixtures exercise it — those files interleave GRIB2 and
GRIB1 messages in one file and GDAL exposes all of them as bands).

Supported: edition 2 with grid definition template 3.0 (regular lat/lon),
data representation template 5.0 (simple packing), bitmap section present
or absent; edition 1 with grid representation 0 (regular lat/lon), simple
packing, IBM-370 reference floats, optional bitmap. Any number of messages
per file (one band each).

Decoded fields become :class:`mosaic_tpu_torch.raster.Raster` objects with a
GDAL-style geotransform, so the whole raster expression surface
(`rst_*`, `raster_to_grid`) applies unchanged.
"""

from __future__ import annotations

import struct

import numpy as np

from ..raster.core import Raster


def _sm16(buf: bytes, off: int) -> int:
    """GRIB2 signed 16-bit: sign bit + magnitude (NOT two's complement)."""
    v = struct.unpack(">H", buf[off : off + 2])[0]
    return -(v & 0x7FFF) if v & 0x8000 else v


def _sm32(buf: bytes, off: int) -> int:
    v = struct.unpack(">I", buf[off : off + 4])[0]
    return -(v & 0x7FFFFFFF) if v & 0x80000000 else v


def _unpack_simple(
    payload: bytes,
    n: int,
    R: float,
    E: int,
    D: int,
    nbits: int,
    single: bool = True,
):
    """Simple packing: value = (R + X * 2^E) / 10^D.

    ``single=True`` does the arithmetic in float32, reproducing GDAL's
    g2clib GRIB2 decode bit-for-bit; GRIB1 passes ``single=False`` because
    GDAL's GRIB1 path computes in double (both verified against the
    fixture's GDAL-generated .aux.xml statistics)."""
    f = np.float32 if single else np.float64
    if nbits == 0:
        return np.full(n, f(R) / f(10.0**D), dtype=np.float64)
    raw = np.frombuffer(payload, dtype=np.uint8)
    bits = np.unpackbits(raw)[: n * nbits].reshape(n, nbits)
    weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
    x = bits.astype(np.int64) @ weights
    v = (f(R) + x.astype(f) * f(2.0**E)) / f(10.0**D)
    return v.astype(np.float64)


def _ibm32(b: bytes) -> float:
    """IBM System/370 32-bit float (GRIB1 reference values)."""
    w = struct.unpack(">I", b)[0]
    sign = -1.0 if w >> 31 else 1.0
    exp = (w >> 24) & 0x7F
    frac = w & 0xFFFFFF
    return sign * (frac / float(1 << 24)) * 16.0 ** (exp - 64)


def _sm24(buf: bytes, off: int) -> int:
    """GRIB1 signed 24-bit: sign bit + magnitude."""
    v = (buf[off] << 16) | (buf[off + 1] << 8) | buf[off + 2]
    return -(v & 0x7FFFFF) if v & 0x800000 else v


def _u24(buf: bytes, off: int) -> int:
    return (buf[off] << 16) | (buf[off + 1] << 8) | buf[off + 2]


def _decode_grib1(buf: bytes, idx: int, msg_len: int):
    """One GRIB1 message -> (grid (nj, ni) float32, gt, meta string)."""
    off = idx + 8  # past IS (8 octets)
    pds_len = _u24(buf, off)
    flags = buf[off + 7]
    param = buf[off + 8]
    D = _sm16(buf, off + 26)
    has_gds = bool(flags & 0x80)
    has_bms = bool(flags & 0x40)
    off += pds_len
    if not has_gds:
        raise ValueError("GRIB1 message without GDS unsupported")
    gds_len = _u24(buf, off)
    rep = buf[off + 5]
    if rep != 0:
        raise ValueError(f"GRIB1 grid representation {rep} unsupported")
    ni = struct.unpack(">H", buf[off + 6 : off + 8])[0]
    nj = struct.unpack(">H", buf[off + 8 : off + 10])[0]
    la1 = _sm24(buf, off + 10) / 1e3
    lo1 = _sm24(buf, off + 13) / 1e3
    la2 = _sm24(buf, off + 17) / 1e3
    lo2 = _sm24(buf, off + 20) / 1e3
    if struct.unpack(">H", buf[off + 23 : off + 25])[0] == 0xFFFF:
        # increments marked missing: derive from the corner coordinates
        di = (lo2 - lo1) / max(ni - 1, 1)
        dj = (la2 - la1) / max(nj - 1, 1)
    else:
        di = _sm16(buf, off + 23) / 1e3
        dj = _sm16(buf, off + 25) / 1e3
    scan = buf[off + 27]
    if scan & 0x20:
        raise ValueError("GRIB1 j-consecutive scanning (0x20) unsupported")
    off += gds_len
    bitmap = None
    if has_bms:
        bms_len = _u24(buf, off)
        unused = buf[off + 3]
        bm_raw = np.frombuffer(buf[off + 6 : off + bms_len], dtype=np.uint8)
        bits = np.unpackbits(bm_raw)
        if bits.size - unused < ni * nj:
            raise ValueError(
                f"GRIB1 bitmap holds {bits.size - unused} bits for "
                f"{ni * nj} grid points"
            )
        bitmap = bits[: ni * nj].astype(bool)
        off += bms_len
    bds_len = _u24(buf, off)
    bds_flags = buf[off + 3] >> 4
    if bds_flags & 0x4:  # complex packing
        raise ValueError("GRIB1 complex packing unsupported")
    E = _sm16(buf, off + 4)
    R = _ibm32(buf[off + 6 : off + 10])
    nbits = buf[off + 10]
    payload = buf[off + 11 : off + bds_len]
    n_data = int(bitmap.sum()) if bitmap is not None else ni * nj
    vals = _unpack_simple(payload, n_data, R, E, D, nbits, single=False)
    if bitmap is not None:
        full = np.full(ni * nj, np.nan)
        full[bitmap] = vals
        vals = full
    grid = np.asarray(vals).reshape(nj, ni)
    if scan & 0x40:
        grid = grid[::-1]
    if scan & 0x80:
        grid = grid[:, ::-1]
    gt = _grib_gt(la1, lo1, ni, nj, abs(di), abs(dj), scan)
    return grid.astype(np.float64), gt, f"GRIB1_PARAM={param}"


def _grib_gt(la1, lo1, ni, nj, di, dj, scan):
    """North-up geotransform from the first grid point + scanning mode.

    la1/lo1 are the CENTER of the first transmitted point: northernmost
    row unless +j scanning (0x40), westernmost column unless -i scanning
    (0x80) — the grid arrays are flipped to north-up/west-east to match.
    """
    lat_top = la1 + (nj - 1) * dj if scan & 0x40 else la1
    lon_west = lo1 - (ni - 1) * di if scan & 0x80 else lo1
    return (lon_west - di / 2, di, 0.0, lat_top + dj / 2, 0.0, -dj)


def _sections(buf: bytes, start: int, msg_len: int):
    """Yield (number, offset, length) for one message's sections 1..7."""
    off = start + 16
    end = start + msg_len
    while off < end - 4:
        if buf[off : off + 4] == b"7777":
            return
        slen = struct.unpack(">I", buf[off : off + 4])[0]
        if slen == 0:
            raise ValueError("zero-length GRIB2 section")
        yield buf[off + 4], off, slen
        off += slen


def read_grib2(path: str) -> Raster:
    """All messages of a GRIB2 file -> one multi-band Raster."""
    buf = open(path, "rb").read()
    bands = []
    gts = []
    meta_rows = []
    pos = 0
    while pos < len(buf) - 16:
        idx = buf.find(b"GRIB", pos)
        if idx < 0 or idx + 16 > len(buf):
            break
        # "GRIB" can occur inside message payloads: require a coherent
        # message (known edition, sane length, '7777' trailer)
        edition = buf[idx + 7]
        if edition == 1:
            msg1 = _u24(buf, idx + 4)
            if (
                32 <= msg1 <= len(buf) - idx
                and buf[idx + msg1 - 4 : idx + msg1] == b"7777"
            ):
                grid, gt1, m = _decode_grib1(buf, idx, msg1)
                bands.append(grid)
                meta_rows.append(m)
                gts.append(gt1)
                pos = idx + msg1
            else:
                pos = idx + 4
            continue
        msg_len = struct.unpack(">Q", buf[idx + 8 : idx + 16])[0]
        valid = (
            edition == 2
            and 32 <= msg_len <= len(buf) - idx
            and buf[idx + msg_len - 4 : idx + msg_len] == b"7777"
        )
        if not valid:
            pos = idx + 4
            continue
        ni = nj = None
        la1 = lo1 = di = dj = None
        scan = 0
        drs = None
        bitmap = None
        data = None
        n_pts = 0
        discipline = buf[idx + 6]
        cat = num = None
        for snum, off, slen in _sections(buf, idx, msg_len):
            if snum == 3:
                tmpl = struct.unpack(">H", buf[off + 12 : off + 14])[0]
                if tmpl != 0:
                    raise ValueError(
                        f"GRIB2 grid template 3.{tmpl} unsupported "
                        "(regular lat/lon only)"
                    )
                n_pts = struct.unpack(">I", buf[off + 6 : off + 10])[0]
                ni = struct.unpack(">I", buf[off + 30 : off + 34])[0]
                nj = struct.unpack(">I", buf[off + 34 : off + 38])[0]
                la1 = _sm32(buf, off + 46) / 1e6
                lo1 = _sm32(buf, off + 50) / 1e6
                di = _sm32(buf, off + 63) / 1e6
                dj = _sm32(buf, off + 67) / 1e6
                scan = buf[off + 71]
                if scan & 0x20:
                    raise ValueError(
                        "GRIB2 j-consecutive scanning (0x20) unsupported"
                    )
            elif snum == 4:
                cat, num = buf[off + 9], buf[off + 10]
            elif snum == 5:
                tmpl = struct.unpack(">H", buf[off + 9 : off + 11])[0]
                if tmpl != 0:
                    raise ValueError(
                        f"GRIB2 data template 5.{tmpl} unsupported "
                        "(simple packing only)"
                    )
                R = struct.unpack(">f", buf[off + 11 : off + 15])[0]
                E = _sm16(buf, off + 15)
                D = _sm16(buf, off + 17)
                nbits = buf[off + 19]
                drs = (R, E, D, nbits)
            elif snum == 6:
                indicator = buf[off + 5]
                if indicator == 0:
                    nbm = -(-n_pts // 8)
                    bm_raw = np.frombuffer(
                        buf[off + 6 : off + 6 + nbm], dtype=np.uint8
                    )
                    bitmap = np.unpackbits(bm_raw)[:n_pts].astype(bool)
                elif indicator != 255:
                    raise ValueError(
                        f"GRIB2 bitmap indicator {indicator} unsupported"
                    )
            elif snum == 7:
                data = buf[off + 5 : off + slen]
        if drs is None or ni is None or data is None:
            raise ValueError("incomplete GRIB2 message")
        n_data = int(bitmap.sum()) if bitmap is not None else ni * nj
        vals = _unpack_simple(data, n_data, *drs)
        if bitmap is not None:
            full = np.full(ni * nj, np.nan)
            full[bitmap] = vals
            vals = full
        grid = vals.reshape(nj, ni)
        if scan & 0x40:  # +j scan: rows south->north; flip to north-up
            grid = grid[::-1]
        if scan & 0x80:  # -i scan: columns east->west
            grid = grid[:, ::-1]
        bands.append(grid.astype(np.float64))
        meta_rows.append(f"GRIB_DISCIPLINE={discipline};CAT={cat};NUM={num}")
        gts.append(_grib_gt(la1, lo1, ni, nj, abs(di), abs(dj), scan))
        pos = idx + msg_len
    if not bands:
        raise ValueError(f"no decodable GRIB messages in {path!r}")
    shapes = {b.shape for b in bands}
    uniq_gt = {tuple(round(v, 9) for v in g) for g in gts}
    if len(shapes) > 1 or len(uniq_gt) > 1:
        raise ValueError(
            f"GRIB messages define different grids (shapes {sorted(shapes)}, "
            f"{len(uniq_gt)} geotransforms); read them as separate rasters"
        )
    gt = gts[0]
    meta = "".join(
        f'<Item name="BAND_{i + 1}">{m}</Item>' for i, m in enumerate(meta_rows)
    )
    return Raster(
        data=np.stack(bands),
        gt=gt,
        srid=4326,
        nodata=float("nan") if any(np.isnan(b).any() for b in bands) else None,
        meta_xml=f"<GDALMetadata>{meta}</GDALMetadata>",
        path=path,
    )
