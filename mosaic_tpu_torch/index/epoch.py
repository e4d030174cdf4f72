"""Epochal mutable indexes: crash-consistent delta tessellation.

Port of ``mosaic_tpu/index/epoch.py``. A :class:`~mosaic_tpu_torch.sql.
join.ChipIndex` is build-once; :class:`EpochalIndex` makes mutation a
durable operation built from three pieces:

- **delta tessellation** (`core/tessellate.tessellate_subset`): only the
  changed geometries are tessellated. :func:`~mosaic_tpu_torch.core.
  tessellate.tessellate` is per-geometry independent, so a delta's chip
  rows are bit-identical to the matching blocks of a from-scratch pass;
- an **epochal chip-table patch**: live chips are held as append-only
  blocks plus a tombstone array per block. An upsert tombstones the
  geometry's old rows and appends its fresh block; ``compact()`` folds
  tombstones out. ``publish()`` materializes the live rows in column
  order — the same ``ChipTable`` a from-scratch ``tessellate`` of the
  current column emits — builds the device index on the index's device
  and swaps it in atomically (through ``ServeEngine.hot_swap`` when an
  engine is given), so in-flight batches finish on the old epoch;
- a **checksummed, fingerprint-chained delta log** in the
  `runtime/checkpoint.py` discipline: every record is an npz payload
  plus a JSON sidecar carrying the payload's SHA-256 and the previous
  record's chain hash, written temp-first and ``os.replace``\\ d,
  payload BEFORE sidecar. A kill at any byte boundary leaves either a
  fully-durable epoch or a truncatable tail. :meth:`EpochalIndex.replay`
  reconstructs the index bit for bit at the newest durable epoch; a
  corrupt *interior* record raises
  :class:`~mosaic_tpu_torch.runtime.errors.EpochLogCorrupt` and a broken
  chain :class:`~mosaic_tpu_torch.runtime.errors.EpochFingerprintMismatch`.

Delta-log format v1, the reference's byte for byte (each package replays
the other's directories):

- ``base-00000000.npz/.json`` — the epoch-0 geometry column (CSR arrays
  and stable ids) and the build parameters; its chain hash is the
  **series** fingerprint every published index carries;
- ``delta-<epoch>.npz/.json`` — removed ids, upserted ids and their
  geometry column; sidecar ``prev`` is the predecessor's chain hash,
  ``chain = sha256(prev + ":" + sha256(payload))``;
- ``compact-<epoch>.npz/.json`` — the full current column with the
  truncated prefix's chain fingerprint sealed in as ``prev``, so replay
  after truncation still proves chain integrity.

Sidecar ``meta`` holds the reference's values: ``"dtype"`` is the numpy
name (``"float32"``) and ``"system"`` the index system's class name.

Fault sites: ``epoch.apply`` (pre-tessellate / pre-append / post-append
boundaries), ``epoch.publish`` (pre-build and the torn boundary between
index swap and epoch-counter bump), ``epoch.compact`` (pre-snapshot /
post-snapshot-pre-truncate / post-truncate).

Knob: ``MOSAIC_EPOCH_LOG_MAX`` (read by `tune/resolve.py`) — when the log
holds at least this many delta records since the last compaction,
``apply`` compacts and truncates (an explicit ``log_max=`` beats the env).

What differs from the reference: ``publish(reprofile=True)`` hands the
engine's ``hot_swap`` the refreshed profile AND the epochal index's own
resolution, so the explicit layer wins over the profile's
``resolution``. The reference passes the profile alone, and its engine
then serves at the resolution the analyzer picked, which the index was
not built at (ROADMAP queue 3). A published index carries
``epoch_series``, ``epoch`` and ``epoch_token``: the program store folds
the token into its keys and drops a series' superseded epochs
(`dispatch/programs.py`, `DispatchCore.warmup`'s ``aot_gc``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.tessellate import ChipTable, tessellate_subset
from ..core.types import GeometryBuilder, PackedGeometry, concat_packed
from ..obs import trace as _trace
from ..runtime import faults as _faults
from ..runtime import telemetry as _telemetry
from ..runtime.errors import EpochFingerprintMismatch, EpochLogCorrupt
from ..tune.resolve import resolve_knob

LOG_VERSION = 1
_REC_RE = re.compile(r"^(base|delta|compact)-(\d{8})\.json$")

# ------------------------------------------------------------ column codec

_COL_KEYS = (
    "xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type",
    "srid", "geom_has_z",
)


def _empty_column() -> PackedGeometry:
    return PackedGeometry(
        xy=np.zeros((0, 2), dtype=np.float64),
        ring_offsets=np.zeros(1, dtype=np.int64),
        part_offsets=np.zeros(1, dtype=np.int64),
        geom_offsets=np.zeros(1, dtype=np.int64),
        geom_type=np.zeros(0, dtype=np.uint8),
        srid=np.zeros(0, dtype=np.int32),
    )


def _col_arrays(col: PackedGeometry, prefix: str = "") -> dict:
    out = {prefix + k: np.asarray(getattr(col, k)) for k in _COL_KEYS}
    out[prefix + "z_present"] = np.asarray(
        1 if col.z is not None else 0, dtype=np.int64
    )
    out[prefix + "z"] = (
        np.asarray(col.z)
        if col.z is not None
        else np.zeros(0, dtype=np.float64)
    )
    return out


def _col_from_arrays(arrays: dict, prefix: str = "") -> PackedGeometry:
    kw = {k: arrays[prefix + k] for k in _COL_KEYS}
    if int(arrays[prefix + "z_present"]):
        kw["z"] = arrays[prefix + "z"]
    return PackedGeometry(**kw)


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s+l) for s, l in zip(starts, lens)])``
    without the Python loop."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lens)
    offs = np.repeat(starts - np.concatenate(([0], ends[:-1])), lens)
    return np.arange(total, dtype=np.int64) + offs


def _gather_packed(src: PackedGeometry, indices) -> PackedGeometry:
    """Vectorized ``PackedGeometry.take`` over the CSR arrays (the
    publish path gathers every live chip row, and ``take`` appends them
    one at a time). Byte for byte the column ``take`` builds; z-carrying
    columns go through ``take`` (chips are 2-D)."""
    idx = np.asarray(indices, np.int64).reshape(-1)
    if src.z is not None:
        return src.take([int(g) for g in idx])
    go = np.asarray(src.geom_offsets, np.int64)
    po = np.asarray(src.part_offsets, np.int64)
    ro = np.asarray(src.ring_offsets, np.int64)
    n_parts = go[idx + 1] - go[idx]
    parts = _concat_ranges(go[idx], n_parts)
    n_rings = po[parts + 1] - po[parts]
    rings = _concat_ranges(po[parts], n_rings)
    n_verts = ro[rings + 1] - ro[rings]
    verts = _concat_ranges(ro[rings], n_verts)
    return PackedGeometry(
        xy=np.asarray(src.xy)[verts],
        ring_offsets=np.concatenate(([0], np.cumsum(n_verts))),
        part_offsets=np.concatenate(([0], np.cumsum(n_rings))),
        geom_offsets=np.concatenate(([0], np.cumsum(n_parts))),
        geom_type=np.asarray(src.geom_type)[idx],
        srid=np.asarray(src.srid)[idx],
        geom_has_z=np.asarray(src.geom_has_z)[idx],
    )


def chip_index_equal(a, b) -> bool:
    """Bitwise identity of two ChipIndexes — the acceptance predicate of
    the epoch contract: a patched index must be indistinguishable from a
    from-scratch rebuild. Every tensor field (the ``border`` geometry's
    included) and the numpy arrays of the ``host`` recheck twin and the
    ``voronoi`` tables, which the exact join and KNN read, must agree in
    shape, dtype and bytes, on whatever device each lies (so ``-0.0`` and
    ``+0.0`` differ)."""
    la, lb = a.to_arrays(), b.to_arrays()
    if la.keys() != lb.keys():
        return False
    for k, x in la.items():
        y = lb[k]
        if (
            x.shape != y.shape
            or x.dtype != y.dtype
            or np.ascontiguousarray(x).tobytes()
            != np.ascontiguousarray(y).tobytes()
        ):
            return False
    return True


def _torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


# ------------------------------------------------------------- delta log

def _encode_record(arrays: dict, prev: str) -> tuple[bytes, str, str]:
    """(payload bytes, payload sha256, chain hash) of one record."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    sha = hashlib.sha256(payload).hexdigest()
    chain = hashlib.sha256(f"{prev}:{sha}".encode()).hexdigest()
    return payload, sha, chain


class _DeltaLog:
    """One directory of chained records (checkpoint discipline: atomic
    temp-write + replace, payload before sidecar)."""

    def __init__(self, root: str):
        self.root = str(root)

    def _paths(self, kind: str, epoch: int) -> tuple[str, str]:
        base = os.path.join(self.root, f"{kind}-{epoch:08d}")
        return base + ".npz", base + ".json"

    def write(
        self, kind: str, epoch: int, payload: bytes, sha: str,
        prev: str, chain: str, meta: dict,
    ) -> None:
        os.makedirs(self.root, exist_ok=True)
        npz_path, json_path = self._paths(kind, epoch)
        tmp = npz_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, npz_path)
        sidecar = {
            "version": LOG_VERSION, "kind": kind, "epoch": int(epoch),
            "sha256": sha, "prev": prev, "chain": chain, "meta": meta,
        }
        tmp = json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sidecar, f, sort_keys=True, indent=1)
        os.replace(tmp, json_path)

    def entries(self) -> list[tuple[str, int]]:
        """Sidecar-backed ``(kind, epoch)`` records, epoch-ordered."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            m = _REC_RE.match(n)
            if m:
                out.append((m.group(1), int(m.group(2))))
        return sorted(out, key=lambda ke: (ke[1], ke[0] != "compact"))

    def load(self, kind: str, epoch: int) -> tuple[dict, dict]:
        """(sidecar, arrays) of one VALID record; raises ValueError on
        any damage (the caller decides truncate-vs-refuse)."""
        npz_path, json_path = self._paths(kind, epoch)
        with open(json_path) as f:
            sidecar = json.load(f)
        if sidecar.get("version") != LOG_VERSION:
            raise ValueError(
                f"unknown log version {sidecar.get('version')!r}"
            )
        with open(npz_path, "rb") as f:
            payload = f.read()
        if hashlib.sha256(payload).hexdigest() != sidecar.get("sha256"):
            raise ValueError("payload checksum mismatch")
        expect = hashlib.sha256(
            f"{sidecar.get('prev')}:{sidecar.get('sha256')}".encode()
        ).hexdigest()
        if sidecar.get("chain") != expect:
            raise ValueError("chain hash does not bind prev+payload")
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: np.array(z[k]) for k in z.files}
        return sidecar, arrays

    def unlink(self, kind: str, epoch: int) -> None:
        for p in self._paths(kind, epoch):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------- epochal index

class EpochalIndex:
    """A mutable, durable chip index published in atomic epochs.

    ``apply`` mutates (delta-tessellate + durable log append + in-memory
    patch), ``publish`` builds the device index on ``device`` (the card
    unless the caller asks for the CPU) and swaps it in atomically,
    ``compact`` folds tombstones and truncates the log, ``replay``
    reconstructs from the log after a kill. The invariant everything
    here serves: at every epoch, the published index is bit-identical to
    ``build_chip_index(tessellate(current column))``.
    """

    def __init__(
        self,
        col: PackedGeometry | None,
        index_system,
        resolution: int,
        *,
        log_dir: str | None = None,
        keep_core_geoms: bool = True,
        dtype=torch.float32,
        max_chips_per_cell: int | None = None,
        recenter: bool = True,
        log_max: int | None = None,
        device=None,
        _defer_base: bool = False,
    ):
        self.system = index_system
        self.resolution = int(resolution)
        self.keep_core_geoms = bool(keep_core_geoms)
        self.dtype = _torch_dtype(dtype)
        self.max_chips_per_cell = max_chips_per_cell
        self.recenter = bool(recenter)
        self.device = resolve_device(device)
        self._log = _DeltaLog(log_dir) if log_dir else None
        self._log_max = log_max
        self._lock = threading.RLock()

        self._geoms: dict[int, PackedGeometry] = {}
        self._order: list[int] = []
        self._blocks: list[dict] = []  # {"table": ChipTable, "dead": bool[]}
        self._applied = 0   # durable epoch counter (count of deltas)
        self._epoch = -1    # last PUBLISHED epoch
        self._chain = ""    # chain hash through the last delta
        self._series = ""   # base record's chain hash
        self._deltas_since_compact = 0
        self._index = None
        if not _defer_base:
            self._init_base(col if col is not None else _empty_column())

    # ------------------------------------------------------------- base

    def _build_meta(self) -> dict:
        return {
            "system": type(self.system).__name__,
            "resolution": self.resolution,
            "keep_core_geoms": self.keep_core_geoms,
            "dtype": str(np.dtype(str(self.dtype).removeprefix("torch."))),
            "max_chips_per_cell": self.max_chips_per_cell,
            "recenter": self.recenter,
        }

    def _load_column(self, col: PackedGeometry, gids: list) -> None:
        """Seat ``col`` under stable ``gids`` as the only chip block."""
        for i, g in enumerate(gids):
            self._geoms[g] = col.take([i])
        self._order = gids
        if gids:
            table = tessellate_subset(
                col, np.arange(len(gids)), self.system, self.resolution,
                self.keep_core_geoms, geom_ids=np.asarray(gids, np.int64),
            )
            self._blocks = [
                {"table": table, "dead": np.zeros(len(table), dtype=bool)}
            ]

    def _init_base(self, col: PackedGeometry) -> None:
        gids = list(range(len(col.geom_type)))
        arrays = dict(_col_arrays(col), ids=np.asarray(gids, np.int64))
        payload, sha, chain = _encode_record(arrays, "")
        if self._log is not None:
            self._log.write(
                "base", 0, payload, sha, "", chain, self._build_meta()
            )
        self._series = self._chain = chain
        self._load_column(col, gids)

    # ------------------------------------------------------- properties

    @property
    def epoch(self) -> int:
        """The last PUBLISHED epoch (-1 before the first publish)."""
        return self._epoch

    @property
    def applied_epoch(self) -> int:
        """The newest DURABLE epoch (count of applied deltas)."""
        return self._applied

    @property
    def index(self):
        """The published ChipIndex (None before the first publish)."""
        return self._index

    @property
    def series(self) -> str:
        """The base record's chain hash — stable across every epoch of
        this index's life, distinct across indexes."""
        return self._series

    @property
    def chain(self) -> str:
        return self._chain

    def epoch_token(self, epoch: int | None = None) -> str:
        e = self._applied if epoch is None else int(epoch)
        return f"{self._series[:12]}:{e}:{self._chain[:12]}"

    def __len__(self) -> int:
        return len(self._order)

    def column(self) -> PackedGeometry:
        """The current geometry column, in stable column order — the
        from-scratch oracle's input."""
        with self._lock:
            order = list(self._order)
            geoms = {g: self._geoms[g] for g in order}
        b = GeometryBuilder()
        for g in order:
            b.append_from(geoms[g], 0)
        return b.build()

    # ------------------------------------------------------------ apply

    def apply(
        self,
        *,
        upsert: PackedGeometry | None = None,
        ids=None,
        remove=(),
    ) -> dict:
        """One durable delta: replace/insert ``upsert`` geometries under
        stable ``ids``, drop ``remove`` ids. Tessellates only the
        changed geometries, appends the delta to the log (the durable
        point — a kill before it loses only this call's work, a kill
        after it replays to the new epoch), then patches the in-memory
        chip table (tombstone + append). Publish separately.
        """
        upsert = upsert if upsert is not None else _empty_column()
        n_up = len(upsert.geom_type)
        ids = np.asarray(
            ids if ids is not None else np.zeros(0, np.int64), np.int64
        ).reshape(-1)
        remove = np.asarray(list(remove), np.int64).reshape(-1)
        if ids.shape[0] != n_up:
            raise ValueError(
                f"{ids.shape[0]} ids for {n_up} upsert geometries"
            )
        if np.intersect1d(ids, remove).size:
            raise ValueError("an id cannot be both upserted and removed")
        unknown = [int(g) for g in remove if int(g) not in self._geoms]
        if unknown:
            raise KeyError(f"cannot remove unknown geometry ids {unknown}")
        epoch = self._applied + 1
        stats = {"epoch": epoch, "upserts": n_up,
                 "removed": int(remove.size), "seconds": {}}
        with _trace.span("epoch.apply", epoch=epoch, upserts=n_up,
                         removed=int(remove.size)):
            _faults.maybe_fail("epoch.apply")  # pre-tessellate boundary
            t0 = time.perf_counter()
            with _telemetry.timed("epoch_stage", stage="tessellate"):
                delta = (
                    tessellate_subset(
                        upsert, np.arange(n_up), self.system,
                        self.resolution, self.keep_core_geoms,
                        geom_ids=ids,
                    )
                    if n_up
                    else None
                )
            stats["seconds"]["tessellate"] = round(
                time.perf_counter() - t0, 6
            )
            stats["chip_rows"] = 0 if delta is None else len(delta)

            _faults.maybe_fail("epoch.apply")  # pre-append boundary
            t0 = time.perf_counter()
            with _telemetry.timed("epoch_stage", stage="append"):
                arrays = dict(_col_arrays(upsert), ids=ids, removed=remove)
                payload, sha, chain = _encode_record(arrays, self._chain)
                if self._log is not None:
                    self._log.write(
                        "delta", epoch, payload, sha, self._chain, chain,
                        {"upserts": n_up, "removed": int(remove.size)},
                    )
            stats["seconds"]["append"] = round(time.perf_counter() - t0, 6)

            _faults.maybe_fail("epoch.apply")  # post-append boundary
            with self._lock:
                self._patch(upsert, ids, remove, delta)
                self._chain = chain
                self._applied = epoch
                self._deltas_since_compact += 1
        _telemetry.record("epoch_applied", **{
            k: v for k, v in stats.items() if k != "seconds"
        })
        limit, _ = resolve_knob("epoch_log_max", self._log_max, None, 0)
        if (
            self._log is not None and limit
            and self._deltas_since_compact >= int(limit)
        ):
            stats["compacted"] = self.compact()
        return stats

    def _patch(self, upsert, ids, remove, delta) -> None:
        """In-memory chip-table patch (caller holds the lock)."""
        gone = np.concatenate([ids, remove])
        if gone.size:
            for blk in self._blocks:
                blk["dead"] |= np.isin(blk["table"].geom_id, gone)
        for g in remove:
            del self._geoms[int(g)]
            self._order.remove(int(g))
        for i, g in enumerate(ids):
            g = int(g)
            if g not in self._geoms:
                self._order.append(g)
            self._geoms[g] = upsert.take([i])
        if delta is not None and len(delta):
            self._blocks.append(
                {"table": delta, "dead": np.zeros(len(delta), dtype=bool)}
            )

    # ------------------------------------------------------ materialize

    def _live(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(block_idx, local_row, gid) of every live chip row, in final
        column order: stable-sorted by geometry position so the rows
        line up with a from-scratch tessellation of ``column()``."""
        with self._lock:
            blocks = list(self._blocks)
            pos = {g: p for p, g in enumerate(self._order)}
        bi, loc, gid = [], [], []
        for i, blk in enumerate(blocks):
            keep = np.nonzero(~blk["dead"])[0]
            if keep.size:
                bi.append(np.full(keep.size, i, dtype=np.int64))
                loc.append(keep.astype(np.int64))
                gid.append(blk["table"].geom_id[keep])
        if not bi:
            z = np.zeros(0, np.int64)
            return z, z, z
        bi = np.concatenate(bi)
        loc = np.concatenate(loc)
        gid = np.concatenate(gid)
        p = np.asarray([pos[int(g)] for g in gid], dtype=np.int64)
        order = np.argsort(p, kind="stable")
        return bi[order], loc[order], gid[order]

    def _materialize(self, labels: str = "pos") -> ChipTable:
        """The live chip table in column order; ``labels`` picks the
        ``geom_id`` column: dense positions (``pos`` — what
        ``build_chip_index`` needs) or stable ids (``gid`` — what a
        compacted base block stores)."""
        bi, loc, gid = self._live()
        with self._lock:
            blocks = list(self._blocks)
            pos = {g: p for p, g in enumerate(self._order)}
        cell = np.zeros(bi.size, np.int64)
        core = np.zeros(bi.size, bool)
        has = np.zeros(bi.size, bool)
        for b in np.unique(bi):
            m = bi == b
            t = blocks[int(b)]["table"]
            cell[m] = t.cell_id[loc[m]]
            core[m] = t.is_core[loc[m]]
            has[m] = t.has_geom[loc[m]]
        if bi.size:
            lens = np.asarray(
                [len(blk["table"].chips) for blk in blocks], np.int64
            )
            base = np.concatenate(([0], np.cumsum(lens)[:-1]))
            chips = _gather_packed(
                concat_packed([blk["table"].chips for blk in blocks]),
                base[bi] + loc,
            )
        else:
            chips = GeometryBuilder().build()
        geom_id = (
            np.asarray([pos[int(g)] for g in gid], dtype=np.int64)
            if labels == "pos"
            else gid
        )
        return ChipTable(
            geom_id=geom_id, cell_id=cell, is_core=core,
            chips=chips, has_geom=has,
        )

    # ---------------------------------------------------------- publish

    def publish(self, engine=None, *, reprofile: bool = False,
                **hot_swap_kw) -> dict:
        """Build the device index for the newest applied epoch and swap
        it in atomically. With ``engine`` (anything exposing
        ``hot_swap(index, profile=...)`` — a ``ServeEngine`` or the
        router's guarded proxy) the new epoch is built and warmed ASIDE
        while in-flight batches keep finishing on the old one; a failed
        swap leaves BOTH the engine and this index on the old epoch. An
        index on the card that fails to build raises: nothing moves to
        the CPU. ``reprofile=True`` re-profiles the mutated workload
        through `tune` and hands the refreshed profile to ``hot_swap`` so
        knobs re-resolve live on the epoch boundary; the swap keeps this
        index's resolution (an explicit ``resolution=`` beats the
        profile's), since the new epoch is built at it."""
        from ..sql.join import build_chip_index

        epoch = self._applied
        stats = {"epoch": epoch, "seconds": {}}
        with _trace.span("epoch.publish", epoch=epoch):
            _faults.maybe_fail("epoch.publish")  # pre-build boundary
            t0 = time.perf_counter()
            with _telemetry.timed("epoch_stage", stage="materialize"):
                table = self._materialize()
            stats["seconds"]["materialize"] = round(
                time.perf_counter() - t0, 6
            )
            stats["chips"] = len(table)
            t0 = time.perf_counter()
            with _telemetry.timed("epoch_stage", stage="build"):
                idx = build_chip_index(
                    table, dtype=self.dtype,
                    max_chips_per_cell=self.max_chips_per_cell,
                    recenter=self.recenter, device=self.device,
                )
                idx.epoch = epoch
                idx.epoch_series = self._series
                idx.epoch_token = self.epoch_token(epoch)
            stats["seconds"]["build"] = round(time.perf_counter() - t0, 6)
            profile = None
            if reprofile:
                profile = self.reprofile()
                stats["reprofiled"] = True
                hot_swap_kw.setdefault("resolution", self.resolution)
            if engine is not None:
                t0 = time.perf_counter()
                swap = engine.hot_swap(idx, profile=profile, **hot_swap_kw)
                stats["seconds"]["swap"] = round(
                    time.perf_counter() - t0, 6
                )
                if isinstance(swap, dict):
                    stats["swap"] = {
                        k: swap[k]
                        for k in ("seconds", "backend_compiles")
                        if k in swap
                    }
            with self._lock:
                self._index = idx
                # the torn-publish boundary: index swapped, counter not
                # yet bumped — a kill here must replay to a clean epoch
                _faults.maybe_fail("epoch.publish")
                self._epoch = epoch
        _telemetry.record(
            "epoch_published", epoch=epoch, chips=stats["chips"],
            token=idx.epoch_token,
        )
        return stats

    def reprofile(self):
        """Re-profile the CURRENT column through `tune` (re-adapt knobs
        as the data mutates, on epoch boundaries). The profile's
        ``resolution`` is the analyzer's pick for the column, which need
        not be this index's."""
        from ..tune import profile_polygons, recommend

        prof = profile_polygons(self.column(), self.system)
        tuning = recommend(prof)
        _telemetry.record(
            "epoch_reprofile", epoch=self._applied,
            geoms=len(self._order),
        )
        return tuning

    # ---------------------------------------------------------- compact

    def compact(self, *, background: bool = False):
        """Fold tombstones into a fresh base block and, when a log is
        bound, write a compacted snapshot sealing the truncated prefix's
        chain fingerprint (sidecar ``prev``), then truncate every older
        record. The delta chain itself is untouched — the next delta
        still chains from the last delta's hash — so a kill at ANY
        compaction boundary leaves replay consistent: before the
        snapshot is durable the old records still replay; after it, the
        snapshot wins and the leftovers are ignored.

        ``background=True`` runs on a worker thread (telemetry sinks,
        trace context and fault plans adopted) and returns the thread.
        """
        if background:
            sinks = _telemetry.current_sinks()
            ctx = _telemetry.current_trace()
            plans = _faults.current_plans()

            def work():
                _telemetry.adopt_sinks(sinks)
                _telemetry.adopt_trace(ctx)
                _faults.adopt_plans(plans)
                try:
                    self.compact()
                except Exception as e:  # lint: broad-except-ok (a failed background compaction degrades to a bigger log, never takes down serving; the telemetry event is the signal)
                    _telemetry.record(
                        "epoch_compact_failed", error=repr(e)[:200]
                    )

            t = threading.Thread(
                target=work, name="epoch-compact", daemon=True
            )
            t.start()
            return t

        stats = {"epoch": self._applied, "seconds": 0.0, "truncated": 0}
        with _trace.span("epoch.compact", epoch=self._applied):
            t0 = time.perf_counter()
            with _telemetry.timed("epoch_stage", stage="compact"):
                _faults.maybe_fail("epoch.compact")  # pre-snapshot
                with self._lock:
                    epoch = self._applied
                    sealed = self._chain
                table = self._materialize(labels="gid")
                column = self.column()
                with self._lock:
                    gids = np.asarray(self._order, np.int64)
                if self._log is not None:
                    arrays = dict(_col_arrays(column), ids=gids)
                    payload, sha, chain = _encode_record(arrays, sealed)
                    meta = dict(
                        self._build_meta(), sealed=sealed, epoch=epoch,
                        series=self._series,
                    )
                    self._log.write(
                        "compact", epoch, payload, sha, sealed, chain,
                        meta,
                    )
                    # post-snapshot, pre-truncation boundary: both the
                    # snapshot and the prefix exist — replay prefers the
                    # snapshot, the leftovers are dead weight
                    _faults.maybe_fail("epoch.compact")
                    for kind, e in self._log.entries():
                        if e <= epoch and not (
                            kind == "compact" and e == epoch
                        ):
                            self._log.unlink(kind, e)
                            stats["truncated"] += 1
                _faults.maybe_fail("epoch.compact")  # post-truncation
                with self._lock:
                    if self._applied == epoch:
                        self._blocks = [{
                            "table": table,
                            "dead": np.zeros(len(table), dtype=bool),
                        }]
                        self._deltas_since_compact = 0
            stats["seconds"] = round(time.perf_counter() - t0, 6)
            stats["rows"] = len(table)
        _telemetry.record("epoch_compacted", **stats)
        return stats

    # ----------------------------------------------------------- replay

    @classmethod
    def replay(
        cls,
        log_dir: str,
        index_system,
        *,
        engine=None,
        publish: bool = True,
        upto: int | None = None,
        log_max: int | None = None,
        device=None,
    ) -> "EpochalIndex":
        """Reconstruct the index from its delta log after a kill (a log
        the reference package wrote replays too).

        Starts from the newest VALID compacted snapshot (falling back to
        the base record while a half-written compaction is just tail
        residue), verifies every subsequent delta's checksum and chain
        hash, truncates a corrupt TAIL (the kill-mid-write residue,
        ``epoch_log_truncated`` telemetry), and refuses typed on
        anything worse: a damaged interior record raises
        :class:`EpochLogCorrupt`, a chain that does not bind raises
        :class:`EpochFingerprintMismatch`. The result is bit-identical
        to a from-scratch rebuild of the surviving epoch — ``upto``
        stops early at a historical epoch for audits. ``device`` is
        where the index is published (default: the card)."""
        log = _DeltaLog(log_dir)
        entries = log.entries()
        if not entries:
            raise EpochLogCorrupt(
                f"no delta log under {log_dir!r}", log_dir=log_dir
            )
        with _trace.span("epoch.replay", log_dir=log_dir), \
                _telemetry.timed("epoch_stage", stage="replay"):
            # newest valid compact wins; an invalid one is kill residue
            # as long as older records can still replay past it
            start = None
            compacts = sorted(
                (e for k, e in entries if k == "compact"), reverse=True
            )
            if upto is not None:
                compacts = [e for e in compacts if e <= upto]
            for e in compacts:
                try:
                    sidecar, arrays = log.load("compact", e)
                except (OSError, ValueError) as err:
                    _telemetry.record(
                        "epoch_log_truncated", log_dir=log_dir,
                        kind="compact", epoch=e, error=repr(err)[:200],
                    )
                    continue
                start = (e, sidecar, arrays)
                break
            if start is None:
                if not any(k == "base" for k, _ in entries):
                    raise EpochLogCorrupt(
                        f"no base record and no valid compacted "
                        f"snapshot under {log_dir!r}",
                        log_dir=log_dir,
                    )
                try:
                    sidecar, arrays = log.load("base", 0)
                except (OSError, ValueError) as err:
                    raise EpochLogCorrupt(
                        f"base record under {log_dir!r} failed "
                        f"validation: {err}", log_dir=log_dir, epoch=0,
                    ) from err
                start = (0, sidecar, arrays)

            start_epoch, sidecar, arrays = start
            meta = sidecar.get("meta", {})
            if meta.get("system") != type(index_system).__name__:
                raise EpochFingerprintMismatch(
                    f"log under {log_dir!r} was written for index "
                    f"system {meta.get('system')!r}, not "
                    f"{type(index_system).__name__!r}",
                    expected=str(meta.get("system")),
                    actual=type(index_system).__name__,
                )
            self = cls(
                None, index_system, int(meta["resolution"]),
                keep_core_geoms=bool(meta["keep_core_geoms"]),
                dtype=meta["dtype"],
                max_chips_per_cell=meta.get("max_chips_per_cell"),
                recenter=bool(meta.get("recenter", True)),
                log_max=log_max,
                device=device,
                _defer_base=True,
            )
            self._log = log
            self._load_column(
                _col_from_arrays(arrays), [int(g) for g in arrays["ids"]]
            )
            self._applied = start_epoch
            self._chain = sidecar["prev"] if sidecar["kind"] == "compact" \
                else sidecar["chain"]
            self._series = (
                sidecar["chain"] if sidecar["kind"] == "base"
                else meta.get("series", sidecar["chain"])
            )

            deltas = sorted(e for k, e in entries if k == "delta")
            deltas = [e for e in deltas if e > start_epoch]
            if upto is not None:
                deltas = [e for e in deltas if e <= upto]
            expect = start_epoch + 1
            for i, e in enumerate(deltas):
                tail = i == len(deltas) - 1
                if e != expect:
                    raise EpochLogCorrupt(
                        f"delta epoch {expect} missing under "
                        f"{log_dir!r} (next present: {e})",
                        log_dir=log_dir, epoch=expect,
                    )
                try:
                    rec, arrays = log.load("delta", e)
                except (OSError, ValueError) as err:
                    if tail:
                        _telemetry.record(
                            "epoch_log_truncated", log_dir=log_dir,
                            kind="delta", epoch=e,
                            error=repr(err)[:200],
                        )
                        log.unlink("delta", e)
                        break
                    raise EpochLogCorrupt(
                        f"delta {e} under {log_dir!r} failed "
                        f"validation with valid successors: {err}",
                        log_dir=log_dir, epoch=e,
                    ) from err
                if rec.get("prev") != self._chain:
                    raise EpochFingerprintMismatch(
                        f"delta {e} under {log_dir!r} chains from "
                        f"{rec.get('prev')!r}, expected {self._chain!r}",
                        expected=self._chain,
                        actual=str(rec.get("prev")), epoch=e,
                    )
                upsert = _col_from_arrays(arrays)
                ids = np.asarray(arrays["ids"], np.int64)
                remove = np.asarray(arrays["removed"], np.int64)
                n_up = ids.shape[0]
                delta = (
                    tessellate_subset(
                        upsert, np.arange(n_up), self.system,
                        self.resolution, self.keep_core_geoms,
                        geom_ids=ids,
                    )
                    if n_up
                    else None
                )
                with self._lock:
                    self._patch(upsert, ids, remove, delta)
                    self._chain = rec["chain"]
                    self._applied = e
                    self._deltas_since_compact += 1
                expect += 1
        _telemetry.record(
            "epoch_replayed", log_dir=log_dir, epoch=self._applied,
            start=start_epoch,
        )
        if publish:
            self.publish(engine)
        return self
