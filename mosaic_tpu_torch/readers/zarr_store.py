"""Zarr v2 store reader (directory or zip), pure host decode.

Reference analog: GDAL's Zarr driver (the reference ships a
`binary/zarr-example` fixture for it). Supports zarr_format 2 arrays with
C or F chunk order, '.'- or '/'-separated chunk keys, missing chunks
(fill_value), zlib/gzip compressor or none; nested groups with `.zattrs`
metadata.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np


class ZarrStore:
    """Read-only key/value view over a directory tree or .zip store."""

    def __init__(self, path: str):
        self.path = path
        if os.path.isfile(path) and path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            self._keys = set(self._zip.namelist())
        else:
            self._zip = None
            self._keys = set()
            for root, _dirs, files in os.walk(path):
                for f in files:
                    rel = os.path.relpath(os.path.join(root, f), path)
                    self._keys.add(rel.replace(os.sep, "/"))

    def get(self, key: str) -> bytes | None:
        if key not in self._keys:
            return None
        if self._zip is not None:
            return self._zip.read(key)
        return open(os.path.join(self.path, key.replace("/", os.sep)), "rb").read()

    def arrays(self) -> list[str]:
        """Paths of every array in the store (keys ending in .zarray)."""
        out = []
        for k in self._keys:
            if k.endswith(".zarray"):
                out.append(k[: -len(".zarray")].rstrip("/"))
        return sorted(out)

    def attrs(self, prefix: str = "") -> dict:
        key = f"{prefix}/.zattrs" if prefix else ".zattrs"
        raw = self.get(key)
        return json.loads(raw) if raw else {}

    def read_array(self, name: str) -> np.ndarray:
        meta_raw = self.get(f"{name}/.zarray" if name else ".zarray")
        if meta_raw is None:
            raise ValueError(f"no array {name!r} in {self.path!r}")
        meta = json.loads(meta_raw)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"zarr_format {meta.get('zarr_format')} unsupported")
        if meta.get("filters"):
            raise ValueError("zarr filters unsupported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") not in ("zlib", "gzip"):
            raise ValueError(f"zarr compressor {comp.get('id')!r} unsupported")
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
        order = meta.get("order", "C")
        dtype = np.dtype(meta["dtype"])
        fill = meta.get("fill_value", 0)
        if fill is None:  # v2 allows null = undefined fill
            fill = np.nan if dtype.kind == "f" else 0
        sep = meta.get("dimension_separator", ".")
        out = np.full(shape, fill, dtype=dtype)
        n_chunks = [-(-s // c) for s, c in zip(shape, chunks)]
        for idx in np.ndindex(*n_chunks):
            key_name = sep.join(str(i) for i in idx)
            key = f"{name}/{key_name}" if name else key_name
            raw = self.get(key)
            if raw is None:
                continue  # missing chunk = fill_value
            if comp is not None:
                raw = zlib.decompress(raw, 47)  # auto-detect zlib/gzip header
            block = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            out[sl] = block[tuple(slice(0, q.stop - q.start) for q in sl)]
        return out


def read_zarr(path: str, array: str | None = None):
    """One array (or the store listing) from a Zarr v2 store.

    Returns (np.ndarray, attrs) for a named (or the only) array.
    """
    store = ZarrStore(path)
    names = store.arrays()
    if array is None:
        if len(names) != 1:
            raise ValueError(
                f"store has {len(names)} arrays — pass array=...: {names}"
            )
        array = names[0]
    return store.read_array(array), store.attrs(array)
