"""Minimal HDF5 reader for NetCDF-4 ingestion (pure host decode, no GDAL).

Reference analog: GDAL's netCDF driver behind `MosaicRasterGDAL.readRaster`
(`core/raster/MosaicRasterGDAL.scala:182-187`; the reference's
`binary/netcdf-coral` fixtures exercise it). This is NOT a general HDF5
implementation — it supports exactly the structures netCDF-4 writes for
gridded products, verified against those fixtures:

- superblock v2/v3 (v0 accepted when the root group uses v2 object headers)
- version-2 object headers (OHDR) + OCHK continuation blocks
- compact Link messages (dense/fractal-heap groups are rejected clearly)
- dataspace v1/v2; fixed-point and IEEE-float datatypes; fill values
- data layout v3: contiguous and chunked (v1 B-tree chunk index)
- filter pipeline v1/v2: shuffle + deflate (fletcher32 checksums stripped)
- compact Attribute messages (v1/v3); densely stored attributes are
  skipped (netCDF-4 stores them densely when creation order is tracked —
  callers must not rely on attrs being complete)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_UNDEF = 0xFFFFFFFFFFFFFFFF


class H5Lite:
    def __init__(self, path: str):
        self.path = path
        self._d = open(path, "rb").read()
        d = self._d
        if d[:8] != b"\x89HDF\r\n\x1a\n":
            raise ValueError(f"{path!r} is not an HDF5 file")
        ver = d[8]
        if ver in (2, 3):
            if d[9] != 8 or d[10] != 8:
                raise ValueError("only 8-byte offsets/lengths supported")
            # sig(8) ver(1) szoff(1) szlen(1) flags(1) base(8) ext(8)
            # eof(8) root(8)
            root = struct.unpack("<Q", d[36:44])[0]
        elif ver == 0:
            # v0: prefix(24) base(8) freespace(8) eof(8) driverinfo(8),
            # then the root symbol-table entry: linkname(8) + OHDR addr.
            # The object header may still be v1 (unsupported) — probed and
            # rejected in _messages with a clear error.
            if d[13] != 8 or d[14] != 8:
                raise ValueError("only 8-byte offsets/lengths supported")
            root = struct.unpack("<Q", d[64:72])[0]
        else:
            raise ValueError(f"HDF5 superblock v{ver} unsupported")
        self._vars: dict[str, int] = {}
        self._info_cache: dict[str, dict] = {}
        self._walk_group(root, "")

    # ------------------------------------------------------------ messages
    def _messages(self, off: int):
        d = self._d
        if d[off : off + 4] != b"OHDR":
            raise ValueError(
                "version-1 object headers unsupported (netCDF-4 files "
                "written with format=NETCDF4 use version 2)"
            )
        flags = d[off + 5]
        p = off + 6
        if flags & 0x20:
            p += 16  # four 4-byte timestamps
        if flags & 0x10:
            p += 4
        sb = 1 << (flags & 0x3)
        size = int.from_bytes(d[p : p + sb], "little")
        p += sb
        blocks = [(p, p + size)]
        out = []
        while blocks:
            q, e = blocks.pop()
            while q < e - 3:
                mt = d[q]
                ms = struct.unpack("<H", d[q + 1 : q + 3])[0]
                q += 4
                if flags & 0x04:
                    q += 2
                if mt == 16:  # continuation
                    addr, ln = struct.unpack("<QQ", d[q : q + 16])
                    if d[addr : addr + 4] == b"OCHK":
                        blocks.append((addr + 4, addr + ln - 4))
                else:
                    out.append((mt, q, ms))
                q += ms
        return out

    def _walk_group(self, off: int, prefix: str):
        for mt, mp, ms in self._messages(off):
            if mt != 6:
                continue
            name, addr = self._parse_link(mp)
            full = f"{prefix}/{name}" if prefix else name
            kinds = {m[0] for m in self._messages(addr)}
            if 8 in kinds or 3 in kinds:  # layout/datatype => dataset
                self._vars[full] = addr
            else:
                self._walk_group(addr, full)

    def _parse_link(self, mp: int):
        d = self._d
        lflags = d[mp + 1]
        q = mp + 2
        if lflags & 0x08:
            if d[q] != 0:  # 0 = hard link; soft/external have a path body
                raise ValueError("soft/external HDF5 links unsupported")
            q += 1
        if lflags & 0x04:
            q += 8
        if lflags & 0x10:
            q += 1
        lsz = 1 << (lflags & 0x3)
        nlen = int.from_bytes(d[q : q + lsz], "little")
        q += lsz
        name = d[q : q + nlen].decode("utf-8", "replace")
        addr = struct.unpack("<Q", d[q + nlen : q + nlen + 8])[0]
        return name, addr

    # ------------------------------------------------------------ datasets
    def datasets(self) -> list[str]:
        return sorted(self._vars)

    def _dataset_info(self, name: str) -> dict:
        if name not in self._vars:
            raise ValueError(f"no dataset {name!r} in {self.path!r}")
        d = self._d
        info: dict = {"filters": [], "fill": None, "attrs": {}}
        for mt, mp, ms in self._messages(self._vars[name]):
            if mt == 1:  # dataspace
                ver, rank = d[mp], d[mp + 1]
                base = mp + 4 if ver == 2 else mp + 8
                info["shape"] = struct.unpack(
                    f"<{rank}Q", d[base : base + 8 * rank]
                )
            elif mt == 3:  # datatype
                info["dtype"] = self._parse_dtype(mp)
            elif mt == 5:  # fill value (v2/v3)
                ver = d[mp]
                if ver == 3:
                    flags = d[mp + 1]
                    if flags & 0x20:
                        n = struct.unpack("<I", d[mp + 2 : mp + 6])[0]
                        info["fill_raw"] = d[mp + 6 : mp + 6 + n]
                elif ver == 2 and d[mp + 3]:
                    n = struct.unpack("<I", d[mp + 4 : mp + 8])[0]
                    info["fill_raw"] = d[mp + 8 : mp + 8 + n]
            elif mt == 8:  # layout
                ver = d[mp]
                if ver != 3:
                    raise ValueError(f"data layout v{ver} unsupported")
                cls = d[mp + 1]
                if cls == 1:  # contiguous
                    addr, sz = struct.unpack("<QQ", d[mp + 2 : mp + 18])
                    info["layout"] = ("contiguous", addr, sz)
                elif cls == 2:  # chunked: rank includes the element-size dim
                    rank = d[mp + 2]
                    addr = struct.unpack("<Q", d[mp + 3 : mp + 11])[0]
                    cdims = struct.unpack(
                        f"<{rank}I", d[mp + 11 : mp + 11 + 4 * rank]
                    )
                    info["layout"] = ("chunked", addr, cdims[:-1])
                elif cls == 0:  # compact
                    sz = struct.unpack("<H", d[mp + 2 : mp + 4])[0]
                    info["layout"] = ("compact", mp + 4, sz)
                else:
                    raise ValueError(f"layout class {cls} unsupported")
            elif mt == 11:  # filter pipeline
                info["filters"] = self._parse_filters(mp)
            elif mt == 12:  # compact attribute
                try:
                    k, v = self._parse_attr(mp)
                    info["attrs"][k] = v
                except Exception:  # lint: broad-except-ok (attrs are best-effort; densely stored ones skip)
                    pass
        if "shape" not in info or "dtype" not in info:
            raise ValueError(f"dataset {name!r} missing dataspace/datatype")
        return info

    def _parse_dtype(self, mp: int) -> np.dtype:
        d = self._d
        cls = d[mp] & 0x0F
        bits0 = d[mp + 1]
        size = struct.unpack("<I", d[mp + 4 : mp + 8])[0]
        if cls == 0:  # fixed point
            signed = bool(bits0 & 0x08)
            return np.dtype(f"{'<' if not (bits0 & 1) else '>'}{'i' if signed else 'u'}{size}")
        if cls == 1:  # float (assume IEEE)
            return np.dtype(f"{'<' if not (bits0 & 1) else '>'}f{size}")
        raise ValueError(f"datatype class {cls} unsupported")

    def _parse_filters(self, mp: int):
        d = self._d
        ver, nf = d[mp], d[mp + 1]
        q = mp + (8 if ver == 1 else 2)
        out = []
        for _ in range(nf):
            fid = struct.unpack("<H", d[q : q + 2])[0]
            if ver == 1 or fid >= 256:
                # fid(2) namelen(2) flags(2) ncv(2) name[padded for v1]
                nlen = struct.unpack("<H", d[q + 2 : q + 4])[0]
                ncv = struct.unpack("<H", d[q + 6 : q + 8])[0]
                q += 8 + nlen + ((-nlen) % 8 if ver == 1 else 0)
            else:
                # v2, known filter: fid(2) flags(2) ncv(2) — no name field
                ncv = struct.unpack("<H", d[q + 4 : q + 6])[0]
                q += 6
            cvals = struct.unpack(f"<{ncv}I", d[q : q + 4 * ncv])
            q += 4 * ncv
            if ver == 1 and ncv % 2:
                q += 4
            out.append((fid, cvals))
        return out

    def _parse_attr(self, mp: int):
        d = self._d
        ver = d[mp]
        if ver == 3:
            nsz, dsz, ssz = struct.unpack("<HHH", d[mp + 2 : mp + 8])
            q = mp + 9  # + name charset byte
            name = d[q : q + nsz].split(b"\0")[0].decode()
            q += nsz
            dt = self._parse_dtype(q)
            q += dsz
            rank = d[q + 1]
            dver = d[q]
            base = q + (4 if dver == 2 else 8)
            shape = struct.unpack(f"<{rank}Q", d[base : base + 8 * rank])
            q += ssz
            n = int(np.prod(shape)) if rank else 1
            val = np.frombuffer(d[q : q + n * dt.itemsize], dtype=dt)
            return name, (val[0] if n == 1 else val)
        raise ValueError(f"attribute v{ver} unsupported")

    # ---------------------------------------------------------------- read
    def attrs(self, name: str) -> dict:
        return self._info_cached(name)["attrs"]

    def _info_cached(self, name: str) -> dict:
        if name not in self._info_cache:
            self._info_cache[name] = self._dataset_info(name)
        return self._info_cache[name]

    def fill_value(self, name: str):
        info = self._info_cached(name)
        raw = info.get("fill_raw")
        if not raw:
            return None
        return np.frombuffer(raw[: info["dtype"].itemsize], dtype=info["dtype"])[0]

    def read(self, name: str) -> np.ndarray:
        info = self._info_cached(name)
        shape = tuple(int(s) for s in info["shape"])
        dt = info["dtype"]
        kind, addr, extra = info["layout"]
        d = self._d
        if kind == "contiguous":
            if addr == _UNDEF:
                return np.full(shape, self.fill_value(name) or 0, dtype=dt)
            n = int(np.prod(shape)) if shape else 1
            return (
                np.frombuffer(d[addr : addr + n * dt.itemsize], dtype=dt)
                .reshape(shape)
                .copy()
            )
        if kind == "compact":
            n = int(np.prod(shape)) if shape else 1
            return (
                np.frombuffer(d[addr : addr + n * dt.itemsize], dtype=dt)
                .reshape(shape)
                .copy()
            )
        chunk = tuple(int(c) for c in extra)
        fill = self.fill_value(name)
        out = np.full(shape, 0 if fill is None else fill, dtype=dt)
        if addr != _UNDEF:
            for coff, csize, fmask, caddr in self._btree_chunks(addr, len(chunk)):
                raw = d[caddr : caddr + csize]
                block = self._defilter(raw, info["filters"], fmask, dt, chunk)
                sl = tuple(
                    slice(o, min(o + c, s))
                    for o, c, s in zip(coff, chunk, shape)
                )
                out[sl] = block[tuple(slice(0, q.stop - q.start) for q in sl)]
        return out

    def _btree_chunks(self, addr: int, rank: int):
        """Walk a v1 B-tree of chunked raw data; yield
        (offsets, nbytes, filter_mask, address)."""
        d = self._d
        stack = [addr]
        while stack:
            node = stack.pop()
            if node == _UNDEF or d[node : node + 4] != b"TREE":
                continue
            level = d[node + 5]
            used = struct.unpack("<H", d[node + 6 : node + 8])[0]
            q = node + 8 + 16  # skip siblings
            key_sz = 8 + (rank + 1) * 8
            for i in range(used):
                nbytes, fmask = struct.unpack("<II", d[q : q + 8])
                offs = struct.unpack(
                    f"<{rank + 1}Q", d[q + 8 : q + 8 + (rank + 1) * 8]
                )[:-1]
                child = struct.unpack(
                    "<Q", d[q + key_sz : q + key_sz + 8]
                )[0]
                if level == 0:
                    yield offs, nbytes, fmask, child
                else:
                    stack.append(child)
                q += key_sz + 8
        return

    def _defilter(self, raw: bytes, filters, fmask, dt, chunk):
        n = int(np.prod(chunk))
        for i, (fid, cvals) in enumerate(reversed(filters)):
            if fmask & (1 << (len(filters) - 1 - i)):
                continue
            if fid == 1:  # deflate
                raw = zlib.decompress(raw)
            elif fid == 2:  # shuffle
                es = cvals[0] if cvals else dt.itemsize
                arr = np.frombuffer(raw, dtype=np.uint8)
                m = arr.size // es
                raw = (
                    arr[: m * es].reshape(es, m).T.reshape(-1).tobytes()
                )
            elif fid == 3:  # fletcher32: strip the trailing checksum
                raw = raw[:-4]
            else:
                raise ValueError(f"HDF5 filter {fid} unsupported")
        return np.frombuffer(raw[: n * dt.itemsize], dtype=dt).reshape(chunk)


def read_netcdf(path: str, variable: str | None = None):
    """NetCDF-4 grid -> Raster (lat/lon coordinate variables define the
    geotransform; 2-D+ variables become bands)."""
    from ..raster.core import Raster

    h5 = H5Lite(path)
    names = h5.datasets()
    candidates = []
    for n in names:
        shape = h5._info_cached(n)["shape"]
        if (
            len(shape) >= 2
            and int(np.prod(shape)) > 1
            and not n.split("/")[-1].endswith(("_bnds", "_bounds"))
        ):
            candidates.append(n)
    # CF files carry auxiliary 2-D variables (bounds, char arrays): keep
    # only the variables sharing the DOMINANT trailing 2-D shape
    from collections import Counter

    tails = Counter(
        tuple(h5._info_cached(n)["shape"][-2:]) for n in candidates
    )
    grids = []
    if tails:
        # largest grid wins (aux char arrays / station tables are small);
        # count only breaks ties between equal-sized grids
        best = max(tails.items(), key=lambda kv: (kv[0][0] * kv[0][1], kv[1]))[0]
        grids = [
            n
            for n in candidates
            if tuple(h5._info_cached(n)["shape"][-2:]) == best
        ]
    if variable is not None:
        if variable not in names:
            raise ValueError(f"no variable {variable!r}; have {names}")
        if len(h5._info_cached(variable)["shape"]) < 2:
            raise ValueError(f"variable {variable!r} is not gridded")
        grids = [variable]
    if not grids:
        raise ValueError(f"no gridded variables in {path!r}; have {names}")
    lat = next((n for n in names if n.split("/")[-1] in ("lat", "latitude")), None)
    lon = next((n for n in names if n.split("/")[-1] in ("lon", "longitude")), None)
    bands = []
    fills = set()
    for g in grids:
        arr = h5.read(g)
        # leading (time/level) dims become extra bands
        arr3 = arr.reshape(-1, arr.shape[-2], arr.shape[-1])
        f = h5.fill_value(g)
        for sl in arr3:
            a = sl.astype(np.float64)
            if f is not None:
                a[sl == f] = np.nan
                fills.add(float(f))
            bands.append(a)
    shapes = {b.shape for b in bands}
    if len(shapes) > 1:
        raise ValueError(f"variables have different grids: {shapes}")
    h, w = bands[0].shape
    if lat is not None and lon is not None:
        la = h5.read(lat).astype(np.float64)
        lo = h5.read(lon).astype(np.float64)
        dy = (la[-1] - la[0]) / max(la.size - 1, 1)
        dx = (lo[-1] - lo[0]) / max(lo.size - 1, 1)
        north_up = dy < 0
        top = la[0] if north_up else la[-1]
        gt = (lo[0] - dx / 2, dx, 0.0, top + abs(dy) / 2, 0.0, -abs(dy))
        flip = not north_up
    else:
        gt = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
        flip = False
    data = np.stack([(b[::-1] if flip else b) for b in bands])
    return Raster(
        data=data,
        gt=gt,
        srid=4326,
        nodata=float("nan") if fills else None,
        meta_xml="",
        path=path,
    )
