"""Index-assisted point-in-polygon join — the main path of the port.

Port of ``mosaic_tpu/sql/join.py``. Points get an H3 cell id, polygons
are tessellated into chips, and the join probes a device-resident
:class:`ChipIndex`:

    key  = (cell * A) >> (64 - log2 T)    multiply-shift hash, no search
    bkt  = table[key]                     1 gather: B candidate (cell, u)
    u    = bucket row whose cell matches  parallel compare, no loop
    edges= cell_edges[u]                  flat gather of the cell's edges
    par  = xor(crossing ? bit : 0)        one parity bit per chip slot
    hit  = core | parity bit

Cells whose chips carry more than ``EDGE_CAP`` edges divert to a HEAVY
table; under ``probe="adaptive"`` their points go through the CUDA kernel
:func:`~mosaic_tpu_torch.kernels.pip.pip_heavy_tiled`, and convex
single-chip cells through a y-bucketed reduced-edge test.

What differs from the reference, and why:

- tensors are torch, on the index's device; the index build is host numpy
  (the same code, so the same arrays), moved to the device at the end;
- slot bits are int32 tensors holding the bit patterns of the
  reference's uint32 values (XOR, then ``>>`` and ``& 1``, read the same
  bits), and the hash multiplier is the int64 bit pattern of its uint64:
  an int64 multiply wraps exactly like the uint64 one, and the logical
  shift is an arithmetic shift followed by a mask;
- ``.at[].set(mode="drop")`` is a write into a buffer with one extra drop
  row, which is then sliced off;
- ``lookup="mxu"|"mxu2"`` and ``compaction="mxu"`` are accepted and run
  the plain gather and scatter lanes: they are matmul workarounds for the
  TPU, and their results are the same;
- ``pip_join`` runs with and without the epsilon-band recheck, with the
  reference's escalation, retry, watchdog and degradation, and takes a
  tuning profile (``profile=``). ``mesh=`` routes each chunk through the
  dispatch core's data-parallel lane, as the reference's does (a
  `parallel.mesh.Mesh`, whose device list may repeat a device). Besides
  the probe attempts, the cell assignment with its
  count read-back and the recheck's narrow re-join also run under
  ``guarded_call("pip_join.device", ...)``, so every wait on the card
  has a watchdog. Degradation to the host oracle follows only a
  transient error that exhausted its retries; the port's own device
  errors are never transient (`runtime/errors.py`);
- cell assignment goes through ``dispatch.cells_prog``, the registered
  cache of cell callables (:func:`join_cache_stats` /
  :func:`clear_join_caches` read and clear it); there is no jit cache.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from .. import FLOAT, resolve_device
from ..context import current_config
from ..core.geometry.device import DeviceGeometry, recenter_shift, to_device
from ..core.index.base import IndexSystem
from ..core.tessellate import ChipTable, tessellate
from ..core.types import GeometryBuilder, GeometryType, PackedGeometry
from ..dispatch import core as _dispatch
from ..obs import trace as _obs_trace
from ..runtime import faults as _faults, telemetry as _telemetry
from ..runtime.errors import DegradedResult, RetryExhausted
from ..runtime.escalate import run_escalating
from ..tune import resolve as _tune_resolve

_SENTINEL = int(np.iinfo(np.int32).max)
_I32_MAX = _SENTINEL
_OVF_MARK = _SENTINEL - 1  # in-probe marker: tier-2 capacity exceeded

#: per-cell flat edge capacity of the tier-1 probe; cells with more edges
#: divert to the heavy table
EDGE_CAP = 32

#: parity bits are 32 wide — at most 32 chip slots per cell and heavy row
MAX_SLOTS = 32

#: result code for points whose probe exceeded a cap (unknown result)
OVERFLOW = -2

#: direct-mode tier-1 chunk rows (bounds the un-compacted (CH, E1, 4)
#: edge intermediate)
_DIRECT_CHUNK = 1 << 20

#: epsilon-band multipliers (the reference's, calibrated by
#: ``tools/calibrate_margins.py``): a point is borderline when its
#: cell-rounding margin (`IndexSystem.point_to_cell_margin`) is below
#: CELL_MARGIN_K·eps(dtype), or within EDGE_BAND_K·eps·coord_scale of a
#: probed chip edge. The port's own sweep
#: (`mosaic_tpu_torch/tools/calibrate_margins.py`, on the CPU in the tests
#: and on the card in ``chip_smoke.py``) must keep 2x headroom under both.
CELL_MARGIN_K = 6.0
EDGE_BAND_K = 16.0

#: convex-lane table shape: y-scanline buckets per convex cell and the
#: per-bucket edge capacity
CONVEX_BUCKETS = 8
CONVEX_EDGE_CAP = 16

@dataclasses.dataclass
class ChipIndex:
    """Device-resident join index over a tessellated polygon table.

    The fields and their meaning are the reference's
    (``mosaic_tpu/sql/join.py ChipIndex``); the dtypes on the device are:

    cells (U,) int64; chip_rows (U, M) int32; chip_geom (C,) int32;
    chip_core (C,) bool; border :class:`DeviceGeometry`;
    hash_mult (1,) int64 (bit pattern of the uint64 multiplier);
    table_cell (T, B) int64; table_slot (T, B) int32; table_pack (T, B)
    int64; pack_low (2,) int64;
    cell_edges (U, E1, 4) f32; cell_ebits (U, E1) int32 (uint32 bit
    patterns); cell_slot_geom (U, M1) int32; cell_slot_core (U, M1) bool;
    cell_heavy (U,) int32;
    heavy_edges (H, E2, 4) f32; heavy_ebits (H, E2) int32;
    heavy_slot_geom (H, M2) int32;
    cell_convex (U,) int32; convex_edges (Cv, KB, EB, 4) f32;
    convex_ebits (Cv, KB, EB) int32; convex_geom (Cv,) int32;
    convex_ybin (Cv, 3) f32.

    Indexes built by :func:`build_chip_index` also carry ``host``, the
    f64 :class:`HostRecheck` companion, and ``voronoi``, the
    :class:`VoronoiTables` of the convex chip sites (both numpy, never on
    the device; ``voronoi`` is None for an index rebuilt from arrays
    without them).
    """

    cells: torch.Tensor
    chip_rows: torch.Tensor
    chip_geom: torch.Tensor
    chip_core: torch.Tensor
    border: DeviceGeometry
    hash_mult: torch.Tensor
    table_cell: torch.Tensor
    table_slot: torch.Tensor
    table_pack: torch.Tensor
    pack_low: torch.Tensor
    cell_edges: torch.Tensor
    cell_ebits: torch.Tensor
    cell_slot_geom: torch.Tensor
    cell_slot_core: torch.Tensor
    cell_heavy: torch.Tensor
    heavy_edges: torch.Tensor
    heavy_ebits: torch.Tensor
    heavy_slot_geom: torch.Tensor
    cell_convex: torch.Tensor
    convex_edges: torch.Tensor
    convex_ebits: torch.Tensor
    convex_geom: torch.Tensor
    convex_ybin: torch.Tensor
    voronoi: "VoronoiTables | None" = None

    @property
    def device(self) -> torch.device:
        return self.cells.device

    @property
    def num_cells(self) -> int:
        return int(self.cells.shape[0])

    @property
    def max_chips_per_cell(self) -> int:
        return int(self.chip_rows.shape[1])

    @property
    def num_heavy_cells(self) -> int:
        return int(self.heavy_edges.shape[0])

    @property
    def num_convex_cells(self) -> int:
        return int(self.convex_edges.shape[0])

    # --------------------------------------------------- numpy round trip
    _BITS = ("cell_ebits", "heavy_ebits", "convex_ebits")
    _BORDER = ("verts", "ring_len", "ring_is_hole", "n_rings", "geom_type", "shift")

    @classmethod
    def field_names(cls) -> list[str]:
        return [
            f.name for f in dataclasses.fields(cls)
            if f.name not in ("border", "voronoi")
        ]

    @classmethod
    def from_arrays(cls, arrays: dict, device=None) -> "ChipIndex":
        """Build from numpy arrays in the reference's dtypes, keyed by field
        name, ``border.<field>`` and (optionally) the ``hr_*`` keys of
        :meth:`HostRecheck.save_arrays`."""
        dev = resolve_device(device)

        def put(a):  # a private, writable copy: never shares the caller's
            return torch.from_numpy(np.array(a, order="C")).to(dev)

        kw = {}
        for n in cls.field_names():
            a = np.asarray(arrays[n])
            if n in cls._BITS:
                a = a.astype(np.uint32).view(np.int32)
            elif n == "hash_mult":
                a = a.astype(np.uint64).view(np.int64)
            kw[n] = put(a)
        kw["border"] = DeviceGeometry(
            **{n: put(np.asarray(arrays[f"border.{n}"])) for n in cls._BORDER}
        )
        idx = cls(**kw)
        idx.host = (
            HostRecheck.from_arrays(arrays) if "hr_cells" in arrays else None
        )
        if "voronoi.sites" in arrays:
            idx.voronoi = VoronoiTables.from_arrays(arrays)
        return idx

    def to_arrays(self) -> dict:
        """The inverse of :meth:`from_arrays`: numpy arrays in the
        reference's dtypes (uint32 bits, uint64 multiplier)."""
        out = {}
        for n in self.field_names():
            a = getattr(self, n).cpu().numpy()
            if n in self._BITS:
                a = a.view(np.uint32)
            elif n == "hash_mult":
                a = a.view(np.uint64)
            out[n] = a
        for n in self._BORDER:
            out[f"border.{n}"] = getattr(self.border, n).cpu().numpy()
        if getattr(self, "host", None) is not None:
            out.update(self.host.save_arrays())
        if self.voronoi is not None:
            out.update(self.voronoi.to_arrays())
        return out


@dataclasses.dataclass
class HostRecheck:
    """Host-side f64 companion of a :class:`ChipIndex`: the same flat
    edge layout in full precision and the same recentring shift, built
    from the pre-narrowing chip coordinates — the exact oracle
    (:func:`host_join_with_cells`). Never crosses to the device.
    """

    cells: np.ndarray  # (U,) int64 sorted
    cell_edges: np.ndarray  # (U, E1, 4) float64
    cell_ebits: np.ndarray
    cell_slot_geom: np.ndarray
    cell_slot_core: np.ndarray
    cell_heavy: np.ndarray
    heavy_edges: np.ndarray  # (H, E2, 4) float64
    heavy_ebits: np.ndarray
    heavy_slot_geom: np.ndarray
    shift: np.ndarray  # (2,) float64
    coord_scale: float  # max |recentered edge coordinate|
    #: these tables on the device of the recheck's oracle, made on first
    #: use (`_OracleTables.of`); never saved
    oracle: "_OracleTables | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )

    _FIELDS = (
        "cells", "cell_edges", "cell_ebits", "cell_slot_geom",
        "cell_slot_core", "cell_heavy", "heavy_edges", "heavy_ebits",
        "heavy_slot_geom", "shift",
    )

    def save_arrays(self) -> dict:
        """{name: array} for npz round-trips."""
        d = {f"hr_{n}": getattr(self, n) for n in self._FIELDS}
        d["hr_coord_scale"] = np.asarray(self.coord_scale)
        return d

    @classmethod
    def from_arrays(cls, z) -> "HostRecheck":
        kw = {n: np.asarray(z[f"hr_{n}"]) for n in cls._FIELDS}
        return cls(coord_scale=float(z["hr_coord_scale"]), **kw)


def _np_parity(px, py, e, bits):
    """Host twin of :func:`_ray_parity` (float64 numpy)."""
    ax, ay, bx, by = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    st = (ay > py[:, None]) != (by > py[:, None])
    den = np.where(by == ay, 1.0, by - ay)
    xc = ax + (py[:, None] - ay) * (bx - ax) / den
    cr = st & (px[:, None] < xc)
    return np.bitwise_xor.reduce(
        np.where(cr, bits, np.uint32(0)).astype(np.uint32), axis=1
    )


def host_join_with_cells(
    points: np.ndarray, cells: np.ndarray, host: HostRecheck
) -> np.ndarray:
    """(N,) int32 — exact f64 host evaluation of the join contract for
    pre-assigned ``cells`` (raw, unshifted ``points``)."""
    p = np.asarray(points, np.float64) - host.shift
    out = np.full(p.shape[0], -1, dtype=np.int32)
    U = host.cells.shape[0]
    if U == 0:
        return out
    u = np.clip(np.searchsorted(host.cells, cells), 0, U - 1)
    fi = np.nonzero(host.cells[u] == cells)[0]
    if fi.size == 0:
        return out
    uf = u[fi]
    px, py = p[fi, 0], p[fi, 1]
    par = _np_parity(px, py, host.cell_edges[uf], host.cell_ebits[uf])
    M = host.cell_slot_geom.shape[1]
    inside = ((par[:, None] >> np.arange(M, dtype=np.uint32)) & 1).astype(bool)
    g = host.cell_slot_geom[uf]
    hit = (g >= 0) & (host.cell_slot_core[uf] | inside)
    best = np.where(hit, g, _I32_MAX).min(axis=1)
    if host.heavy_edges.shape[0]:
        hrow = host.cell_heavy[uf]
        hi_ = np.nonzero(hrow >= 0)[0]
        if hi_.size:
            h = hrow[hi_]
            par2 = _np_parity(
                px[hi_], py[hi_], host.heavy_edges[h], host.heavy_ebits[h]
            )
            M2 = host.heavy_slot_geom.shape[1]
            in2 = (
                (par2[:, None] >> np.arange(M2, dtype=np.uint32)) & 1
            ).astype(bool)
            g2 = host.heavy_slot_geom[h]
            b2 = np.where((g2 >= 0) & in2, g2, _I32_MAX).min(axis=1)
            best[hi_] = np.minimum(best[hi_], b2)
    out[fi] = np.where(best == _I32_MAX, -1, best).astype(np.int32)
    return out


def host_join(
    points: np.ndarray,
    host: HostRecheck,
    index_system: IndexSystem,
    resolution: int,
) -> np.ndarray:
    """Exact f64 host join: f64 cell assignment (numpy host path) + f64
    flat-edge probe. The oracle the port's f32 device join is reported
    against."""
    cells = np.asarray(
        index_system.point_to_cell(np.asarray(points, np.float64), resolution)
    )
    return host_join_with_cells(points, cells, host)


@dataclasses.dataclass
class _OracleTables:
    """A :class:`HostRecheck`'s f64 tables on one device, with the boundary
    rings of its cells under one index system: what :func:`recheck_oracle`
    reads."""

    device: torch.device
    index_system: IndexSystem
    shift: torch.Tensor  # (2,) f64
    cells: torch.Tensor  # (U,) int64 sorted
    cell_edges: torch.Tensor
    cell_ebits: torch.Tensor  # int32 bit patterns
    cell_slot_geom: torch.Tensor
    cell_slot_core: torch.Tensor
    cell_heavy: torch.Tensor
    heavy_edges: torch.Tensor
    heavy_ebits: torch.Tensor
    heavy_slot_geom: torch.Tensor
    rings: torch.Tensor  # (U, B, 2) f64

    @classmethod
    def of(
        cls, host: HostRecheck, index_system: IndexSystem, device: torch.device
    ) -> "_OracleTables":
        """The tables of ``host`` on ``device``: made on first use and kept
        on ``host`` (one device and index system at a time)."""
        t = host.oracle
        if t is not None and t.device == device and t.index_system is index_system:
            return t

        def up(a):
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        rings = np.asarray(index_system.cell_boundary(host.cells), np.float64)
        host.oracle = cls(device, index_system, *(up(getattr(host, n)) for n in (
            "shift", "cells", "cell_edges", "cell_ebits", "cell_slot_geom",
            "cell_slot_core", "cell_heavy", "heavy_edges", "heavy_ebits",
            "heavy_slot_geom")), up(rings))
        return host.oracle

    def lookup(self, cells: torch.Tensor):
        """(row of each cell in the tables, whether the cell is indexed)."""
        u = torch.searchsorted(self.cells, cells).clamp(max=self.cells.shape[0] - 1)
        return u, self.cells[u] == cells

    def answers(self, p: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """(N,) int32: :func:`host_join_with_cells` of recentred f64 points
        ``p``, the same operations in the same order on torch tensors."""
        u, found = self.lookup(cells)
        px, py = p[:, 0], p[:, 1]
        best = _slot_best(
            _ray_parity(px, py, self.cell_edges[u], self.cell_ebits[u]),
            self.cell_slot_geom[u], self.cell_slot_core[u],
        )
        if self.heavy_edges.shape[0]:
            hrow = torch.where(found, self.cell_heavy[u], -1)
            hi = torch.nonzero(hrow >= 0).squeeze(1)
            if hi.numel():
                h = hrow[hi].long()
                b2 = _slot_best(
                    _ray_parity(px[hi], py[hi], self.heavy_edges[h], self.heavy_ebits[h]),
                    self.heavy_slot_geom[h],
                )
                best[hi] = torch.minimum(best[hi], b2)
        return torch.where(found & (best != _SENTINEL), best, -1).to(torch.int32)

    def ring_holds(self, points: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """(N,) bool: does the boundary ring of ``cells[i]`` (as the
        tessellation clipped chips to it) hold the raw f64 ``points[i]``?"""
        u, known = self.lookup(cells)
        ring = self.rings[u]
        if not bool(known.all()):
            fresh = torch.as_tensor(np.asarray(
                self.index_system.cell_boundary(cells[~known].cpu().numpy()),
                np.float64)).to(self.device)
            width = max(ring.shape[1], fresh.shape[1])

            def pad(r):
                # repeat the last vertex: a zero-length edge crosses nothing
                return torch.cat([r, r[:, -1:].expand(-1, width - r.shape[1], -1)], dim=1)

            ring = pad(ring)
            ring[~known] = pad(fresh)
        edges = torch.cat([ring, torch.roll(ring, -1, dims=1)], dim=2)
        ones = torch.ones(edges.shape[:2], dtype=torch.int32, device=self.device)
        return _ray_parity(points[:, 0], points[:, 1], edges, ones) == 1


#: rows the recheck's oracle evaluates at once: a 4M chunk's tie rows
#: (about 150k on curbside points) in one block, as each block costs a few
#: hundred small launches, while its (rows, edges, 4) f64 gathers stay
#: within about 2 GB
ORACLE_BLOCK = 1 << 18


def recheck_oracle(
    points,
    host: HostRecheck,
    index_system: IndexSystem,
    resolution: int,
    device=None,
) -> np.ndarray:
    """(N,) int32 — the recheck's f64 answer for the rows it cannot settle
    in f32: the smallest id among the chips, in every cell whose boundary
    ring holds the point, that contain it.

    The chips are clipped to each cell's ring, whose edges are straight
    in the index system's coordinates; an H3 cell's own edges are not, so
    a point within about 1e-9 degrees of a cell edge may lie outside the
    ring of its f64 cell and inside a neighbour's. :func:`host_join`
    tests only the f64 cell's chips and answers such a point as if no
    zone held it there; here its answer comes from the neighbours
    (`IndexSystem.k_ring`) whose ring holds it. Elsewhere, and where no
    ring holds the point, the answer is :func:`host_join`'s: the same f64
    operations in the same order, on torch tensors on ``device`` (default
    the CPU), in blocks of :data:`ORACLE_BLOCK` rows. (On the card H3's f64
    cells may differ from numpy's within a few ulps of a cell edge, where
    the ring test decides.)"""
    dev = torch.device("cpu") if device is None else torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float64)).to(dev)
    out = np.full(pts.shape[0], -1, np.int32)
    if not host.cells.shape[0]:
        return out
    t = _OracleTables.of(host, index_system, dev)
    for s in range(0, pts.shape[0], ORACLE_BLOCK):
        out[s : s + ORACLE_BLOCK] = _oracle_block(
            pts[s : s + ORACLE_BLOCK], t, resolution
        ).cpu().numpy()
    return out


def _oracle_block(pts: torch.Tensor, t: _OracleTables, resolution: int):
    """:func:`recheck_oracle` of one block of raw f64 points on t's device."""
    cells = torch.as_tensor(t.index_system.point_to_cell(pts, resolution)).to(t.device)
    p = pts - t.shift
    out = t.answers(p, cells)
    gone = torch.nonzero(~t.ring_holds(pts, cells)).squeeze(1)
    if not gone.numel():
        return out
    around = torch.as_tensor(
        np.asarray(t.index_system.k_ring(cells[gone].cpu().numpy(), 1))
    ).to(t.device)
    best = torch.full((gone.numel(),), _SENTINEL, dtype=torch.int32, device=t.device)
    held = torch.zeros(gone.numel(), dtype=torch.bool, device=t.device)
    for col in around.T:
        k = torch.nonzero((col >= 0) & (col != cells[gone])).squeeze(1)
        k = k[t.ring_holds(pts[gone[k]], col[k])]
        if not k.numel():
            continue
        held[k] = True
        a = t.answers(p[gone[k]], col[k])
        best[k] = torch.minimum(best[k], torch.where(a >= 0, a, _SENTINEL))
    fix = gone[held]
    out[fix] = torch.where(best[held] == _SENTINEL, -1, best[held])
    return out


def _build_hash(cells: np.ndarray, max_bucket: int = 8):
    """Host: bucketed multiply-shift hash over the unique cell ids.

    Returns (mult, table_cell (T, B), table_slot (T, B), table_pack,
    pack_low) — the reference's construction and random stream, so the
    tables are the same arrays. T ~= 4x the cell count (power of two);
    the multiplier search prefers a fullest bucket of <= 2 at that size.
    """
    U = cells.shape[0]
    bits = max(4, int(np.ceil(np.log2(max(4 * U, 16)))))
    bits_cap = bits + 6  # bound table growth (and host memory) at 64x
    rng = np.random.default_rng(0xC0FFEE)
    cells_u64 = cells.astype(np.uint64)
    counts = np.zeros(1, dtype=np.int64)
    mult = np.uint64(1)
    found = False
    for b2 in (bits, bits + 1):
        # Poisson estimate of >=3-entry buckets: skip a hopeless hunt
        lam = U / float(1 << b2)
        if (1 << b2) * lam**3 / 6.0 * np.exp(-lam) > 7.0:
            continue
        for _ in range(400):
            cand = np.uint64(
                rng.integers(0, 2**64, dtype=np.uint64) | np.uint64(1)
            )
            k = (cells_u64 * cand) >> np.uint64(64 - b2)
            c = np.bincount(k.astype(np.int64), minlength=1 << b2)
            if c.max() <= 2:
                mult, keys, counts, found = cand, k, c, True
                bits = b2
                break
        if found:
            break
    if not found:
        for attempt in range(32):
            mult = np.uint64(
                rng.integers(0, 2**64, dtype=np.uint64) | np.uint64(1)
            )
            keys = (cells_u64 * mult) >> np.uint64(64 - bits)
            counts = np.bincount(keys.astype(np.int64), minlength=1 << bits)
            if counts.max() <= max_bucket:
                break
            if attempt < 31 and bits < bits_cap:
                bits += 1  # grow the table if this multiplier clusters
    B = int(counts.max()) if U else 1
    T = 1 << bits
    table_cell = np.full((T, B), -1, dtype=np.int64)
    table_slot = np.full((T, B), -1, dtype=np.int32)
    fill = np.zeros(T, dtype=np.int64)
    for u, (c, k) in enumerate(zip(cells, keys.astype(np.int64))):
        table_cell[k, fill[k]] = c
        table_slot[k, fill[k]] = u
        fill[k] += 1

    # slot-packed variant: when all cells share their low k bits and
    # slot+1 fits in k bits, one int64 entry carries both cell and slot
    table_pack = np.zeros((0, 0), dtype=np.int64)
    pack_low = np.zeros(2, dtype=np.int64)
    if U:
        diff = np.bitwise_or.reduce(cells ^ cells[0])
        k_bits = int(diff & -diff).bit_length() - 1 if diff else 63
        k_bits = min(k_bits, 62)
        if k_bits > 0 and (U + 1) < (1 << k_bits):
            low = np.int64((1 << k_bits) - 1)
            table_pack = np.where(
                table_slot >= 0,
                (table_cell & ~low) | (table_slot.astype(np.int64) + 1),
                np.int64(0),
            )
            pack_low = np.asarray([low, cells[0] & low], dtype=np.int64)
    return mult, table_cell, table_slot, table_pack, pack_low


def _round8(n: int, lo: int = 8) -> int:
    return max(lo, (n + 7) // 8 * 8)


def build_chip_index(
    table: ChipTable,
    dtype=FLOAT,
    max_chips_per_cell: int | None = None,
    recenter: bool = True,
    edge_cap: int = EDGE_CAP,
    device=None,
) -> ChipIndex:
    """Host: compile a ChipTable into the join index on ``device``
    (default: the card). The tables are built in numpy exactly as the
    reference builds them, then moved to the device."""
    dev = resolve_device(device)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    C = len(table)
    if C == 0:
        raise ValueError("empty chip table")
    order = np.argsort(table.cell_id, kind="stable")
    sorted_cells = table.cell_id[order]
    uniq, starts, counts = np.unique(
        sorted_cells, return_index=True, return_counts=True
    )
    M = int(max_chips_per_cell or counts.max())
    if counts.max() > M:
        raise ValueError(
            f"cell with {counts.max()} chips exceeds max_chips_per_cell={M}"
        )
    U = uniq.size
    rows = np.full((U, M), -1, dtype=np.int32)
    chip_cell_slot = np.full(C, -1, dtype=np.int64)  # chip -> cell row u
    for i, (s, c) in enumerate(zip(starts, counts)):
        rows[i, :c] = order[s : s + c]
        chip_cell_slot[order[s : s + c]] = i
    # only border rows need vertices: blank core chip geometries before
    # padding so V is set by the clipped border chips
    chips = table.chips
    if table.is_core.any() and table.has_geom[table.is_core].any():
        b = GeometryBuilder()
        for g in range(C):
            if table.is_core[g]:
                b.add_geometry(GeometryType.POLYGON, [[np.zeros((0, 2))]], 0)
            else:
                b.append_from(chips, g)
        chips = b.build()
    # recenter in f64 before narrowing (shrinks the f32 ulp near the data);
    # the padded f64 coordinates are kept for the HostRecheck companion
    padded = chips.to_padded(dtype=np.float64)
    shift64 = recenter_shift(padded) if recenter else np.zeros(2)
    bverts64 = np.where(
        (np.asarray(padded.ring_len)[:, :, None] > 0)[..., None],
        np.asarray(padded.verts, dtype=np.float64) - shift64,
        0.0,
    )
    border = to_device(
        padded, dtype=dtype, shifted_verts=bverts64, shift=shift64, device=dev
    )

    mult, table_cell, table_slot, table_pack, pack_low = _build_hash(uniq)

    bverts = bverts64.astype(np_dtype)  # (C, R, V, 2), recentered
    blen = np.asarray(padded.ring_len)  # (C, R)
    btype = np.asarray(padded.geom_type)
    is_poly = (btype == GeometryType.POLYGON) | (btype == GeometryType.MULTIPOLYGON)
    contributes = is_poly & ~table.is_core  # chips whose edges are probed

    # flat edge extraction: one (chip, ring, e) triple per real edge
    Rr, V = bverts.shape[1], bverts.shape[2]
    e_idx = np.arange(V - 1)
    emask = (
        contributes[:, None, None]
        & (e_idx[None, None, :] < blen[:, :, None])
    )  # (C, R, V-1)
    ec, er, ee = np.nonzero(emask)
    e_a = bverts[ec, er, ee]  # (E, 2)
    e_b = bverts[ec, er, ee + 1]
    edges_all = np.concatenate([e_a, e_b], axis=1).astype(bverts.dtype)  # (E,4)
    edges_all64 = np.concatenate(
        [bverts64[ec, er, ee], bverts64[ec, er, ee + 1]], axis=1
    )  # (E, 4) f64 twin, same row order
    e_cell = chip_cell_slot[ec]  # (E,) cell row u per edge

    # per-cell edge totals decide light vs heavy
    epc = np.bincount(e_cell, minlength=U)
    heavy_mask = epc > edge_cap
    heavy_u = np.nonzero(heavy_mask)[0]
    H = heavy_u.size
    cell_heavy = np.full(U, -1, dtype=np.int32)
    cell_heavy[heavy_u] = np.arange(H, dtype=np.int32)

    # chip slot assignment per tier (per-cell-local parity bit positions)
    chip_heavy_tier = contributes & heavy_mask[chip_cell_slot]
    f2 = chip_heavy_tier[order]
    f1 = ~f2
    c1 = np.cumsum(f1)
    c2 = np.cumsum(f2)
    start_pos = np.repeat(starts, counts)
    base1 = np.concatenate([[0], c1])[start_pos]
    base2 = np.concatenate([[0], c2])[start_pos]
    rank1 = c1 - 1 - base1  # valid where f1
    rank2 = c2 - 1 - base2  # valid where f2
    t1_slot = np.full(C, -1, dtype=np.int64)
    t2_slot = np.full(C, -1, dtype=np.int64)
    t1_slot[order[f1]] = rank1[f1]
    t2_slot[order[f2]] = rank2[f2]
    n1_per_cell = np.bincount(chip_cell_slot[~chip_heavy_tier], minlength=U)
    n2_per_cell = np.bincount(chip_cell_slot[chip_heavy_tier], minlength=U)
    M1 = max(1, int(n1_per_cell.max(initial=0)))
    M2 = max(1, int(n2_per_cell.max(initial=0)))
    if M1 > MAX_SLOTS or M2 > MAX_SLOTS:
        raise ValueError(
            f"a cell holds more than {MAX_SLOTS} chips per probe tier "
            f"(M1={M1}, M2={M2}); parity bits are 32 wide — merge chips or "
            "raise the tessellation resolution"
        )
    slot_geom = np.full((U, M1), -1, dtype=np.int32)
    slot_core = np.zeros((U, M1), dtype=bool)
    ch1 = np.nonzero(~chip_heavy_tier)[0]
    slot_geom[chip_cell_slot[ch1], t1_slot[ch1]] = table.geom_id[ch1].astype(
        np.int32
    )
    slot_core[chip_cell_slot[ch1], t1_slot[ch1]] = table.is_core[ch1]

    # pack tier-1 edges: light-tier edges only, grouped per cell
    t1_edge = t1_slot[ec] >= 0
    E1 = _round8(min(int(epc.max(initial=0)), edge_cap))
    cell_edges = np.zeros((U, E1, 4), dtype=bverts.dtype)
    cell_edges64 = np.zeros((U, E1, 4), dtype=np.float64)
    cell_ebits = np.zeros((U, E1), dtype=np.uint32)
    if t1_edge.any():
        cu = e_cell[t1_edge]
        ord1 = np.argsort(cu, kind="stable")
        cu = cu[ord1]
        ed = edges_all[t1_edge][ord1]
        bits = np.uint32(1) << t1_slot[ec][t1_edge][ord1].astype(np.uint32)
        pos = np.arange(cu.size) - np.searchsorted(cu, cu)
        cell_edges[cu, pos] = ed
        cell_edges64[cu, pos] = edges_all64[t1_edge][ord1]
        cell_ebits[cu, pos] = bits

    # pack tier-2 heavy rows
    if H:
        t2_edge = t2_slot[ec] >= 0
        hrow = cell_heavy[e_cell[t2_edge]].astype(np.int64)
        ord2 = np.argsort(hrow, kind="stable")
        hrow = hrow[ord2]
        ed2 = edges_all[t2_edge][ord2]
        bits2 = np.uint32(1) << t2_slot[ec][t2_edge][ord2].astype(np.uint32)
        eph = np.bincount(hrow, minlength=H)
        E2 = _round8(int(eph.max(initial=1)))
        heavy_edges = np.zeros((H, E2, 4), dtype=bverts.dtype)
        heavy_edges64 = np.zeros((H, E2, 4), dtype=np.float64)
        heavy_ebits = np.zeros((H, E2), dtype=np.uint32)
        pos2 = np.arange(hrow.size) - np.searchsorted(hrow, hrow)
        heavy_edges[hrow, pos2] = ed2
        heavy_edges64[hrow, pos2] = edges_all64[t2_edge][ord2]
        heavy_ebits[hrow, pos2] = bits2
        hgeom = np.full((H, M2), -1, dtype=np.int32)
        ch2 = np.nonzero(chip_heavy_tier)[0]
        hgeom[
            cell_heavy[chip_cell_slot[ch2]], t2_slot[ch2]
        ] = table.geom_id[ch2].astype(np.int32)
    else:
        heavy_edges = np.zeros((0, 8, 4), dtype=bverts.dtype)
        heavy_edges64 = np.zeros((0, 8, 4), dtype=np.float64)
        heavy_ebits = np.zeros((0, 8), dtype=np.uint32)
        hgeom = np.zeros((0, 1), dtype=np.int32)

    coord_scale = (
        float(np.abs(edges_all64).max()) if edges_all64.size else 1.0
    )
    (
        cell_convex, convex_edges, convex_ebits, convex_geom, convex_ybin,
    ) = _build_convex_tables(
        U, epc, heavy_mask, cell_edges, slot_geom, slot_core, coord_scale
    )
    arrays = {
        "cells": uniq.astype(np.int64),
        "chip_rows": rows,
        "chip_geom": table.geom_id.astype(np.int32),
        "chip_core": table.is_core,
        "hash_mult": np.asarray([mult], dtype=np.uint64),
        "table_cell": table_cell,
        "table_slot": table_slot,
        "table_pack": table_pack,
        "pack_low": pack_low,
        "cell_edges": cell_edges,
        "cell_ebits": cell_ebits,
        "cell_slot_geom": slot_geom,
        "cell_slot_core": slot_core,
        "cell_heavy": cell_heavy,
        "heavy_edges": heavy_edges,
        "heavy_ebits": heavy_ebits,
        "heavy_slot_geom": hgeom,
        "cell_convex": cell_convex,
        "convex_edges": convex_edges,
        "convex_ebits": convex_ebits,
        "convex_geom": convex_geom,
        "convex_ybin": convex_ybin,
    }
    arrays.update(
        {f"border.{n}": getattr(border, n).cpu().numpy() for n in ChipIndex._BORDER}
    )
    idx = ChipIndex.from_arrays(arrays, device=dev)
    idx.host = HostRecheck(
        cells=uniq.astype(np.int64),
        cell_edges=cell_edges64,
        cell_ebits=cell_ebits,
        cell_slot_geom=slot_geom,
        cell_slot_core=slot_core,
        cell_heavy=cell_heavy,
        heavy_edges=heavy_edges64,
        heavy_ebits=heavy_ebits,
        heavy_slot_geom=hgeom,
        shift=shift64,
        coord_scale=coord_scale,
    )
    # Voronoi adjacency of the convex chip sites, host numpy like
    # ``host``: the KNN frontend's convex lane walks it (knn/frontend.py)
    idx.voronoi = _build_voronoi_tables(
        uniq, cell_convex, epc, cell_edges64, convex_geom, shift64
    )
    return idx


@dataclasses.dataclass
class VoronoiTables:
    """Host-side Voronoi adjacency of the convex chip sites: one site per
    convex-lane cell (the single chip's vertex centroid), with the
    Delaunay-dual neighbour lists that make "move to the adjacent site
    closer to the query" walks possible (the reference's
    ``sql/join.py VoronoiTables``, field for field).

    The KNN frontend's Voronoi lane walks it to bound a query's kth
    distance, which collapses the iterative ring loop into one
    guaranteed-cover dispatch. Correctness never depends on the
    adjacency (the ring cover is what is exact); its quality only sets
    how tight the bound is, which is why the nearest-neighbour fallback
    is sound.

    sites:    (Cv, 2) f64 — convex chip vertex centroids (recentred frame).
    adjacency:(Cv, DEG) int32 — neighbouring convex rows, -1 padded.
    geom:     (Cv,) int32 — the site's source polygon row (== convex_geom).
    cell:     (Cv,) int64 — the site's cell id.
    shift:    (2,) f64 — the recenter origin of ``sites``; walks subtract
              it from raw queries.
    method:   "delaunay" | "nearest" — how adjacency was derived.
    """

    sites: np.ndarray
    adjacency: np.ndarray
    geom: np.ndarray
    cell: np.ndarray
    shift: np.ndarray
    method: str

    _ARRAYS = ("sites", "adjacency", "geom", "cell", "shift")

    @property
    def num_sites(self) -> int:
        return int(self.sites.shape[0])

    def to_arrays(self) -> dict:
        """``voronoi.<field>`` numpy arrays (``method`` as a 0-d string)."""
        out = {f"voronoi.{n}": np.asarray(getattr(self, n)) for n in self._ARRAYS}
        out["voronoi.method"] = np.asarray(self.method)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict) -> "VoronoiTables":
        return cls(
            **{n: np.array(arrays[f"voronoi.{n}"]) for n in cls._ARRAYS},
            method=str(np.asarray(arrays["voronoi.method"])),
        )


def _voronoi_adjacency(sites: np.ndarray):
    """(Cv, DEG) int32 neighbour lists: the Delaunay dual (scipy), or the
    nearest-DEG heuristic when the sites are too few or degenerate for a
    triangulation — it only loosens the walk's bound, never the
    exactness of the ring cover."""
    Cv = sites.shape[0]
    if Cv <= 1:
        return np.full((Cv, 1), -1, dtype=np.int32), "nearest"
    neigh = [set() for _ in range(Cv)]
    method = "nearest"
    if Cv >= 4:
        from scipy.spatial import Delaunay, QhullError

        try:
            tri = Delaunay(sites)
        except (QhullError, ValueError):
            pass  # degenerate (collinear) sites: the fallback below
        else:
            for simplex in tri.simplices:
                for i in simplex:
                    for j in simplex:
                        if i != j:
                            neigh[i].add(int(j))
            method = "delaunay"
    if method == "nearest":
        deg = min(8, Cv - 1)
        d2 = ((sites[:, None, :] - sites[None, :, :]) ** 2).sum(axis=-1)
        np.fill_diagonal(d2, np.inf)
        nearest = np.argsort(d2, axis=1, kind="stable")[:, :deg]
        for i in range(Cv):
            neigh[i].update(int(j) for j in nearest[i])
            # symmetrize so walks can traverse in both directions
            for j in nearest[i]:
                neigh[int(j)].add(i)
    deg = max(1, max(len(s) for s in neigh))
    adj = np.full((Cv, deg), -1, dtype=np.int32)
    for i, s in enumerate(neigh):
        row = sorted(s)
        adj[i, : len(row)] = row
    return adj, method


def _build_voronoi_tables(
    uniq, cell_convex, epc, cell_edges, convex_geom, shift
) -> VoronoiTables:
    """Host: site + adjacency tables over the convex-lane cells, built
    from the same f64 edge rows as the convex tables."""
    rows = np.nonzero(cell_convex >= 0)[0]
    Cv = rows.size
    sites = np.zeros((Cv, 2), dtype=np.float64)
    cell = np.zeros(Cv, dtype=np.int64)
    for u in rows:
        r = int(cell_convex[u])
        k = int(epc[u])
        # one closed convex ring: the edge 'a' endpoints enumerate the
        # ring's vertices exactly once
        sites[r] = cell_edges[u, :k, 0:2].astype(np.float64).mean(axis=0)
        cell[r] = uniq[u]
    adj, method = _voronoi_adjacency(sites)
    return VoronoiTables(
        sites=sites, adjacency=adj,
        geom=np.asarray(convex_geom, dtype=np.int32), cell=cell,
        shift=np.asarray(shift, dtype=np.float64), method=method,
    )


def _build_convex_tables(
    U, epc, heavy_mask, cell_edges, slot_geom, slot_core, coord_scale
):
    """Host: classify convex-eligible cells and y-bucket their edges.

    A cell qualifies when it is light, holds exactly one non-core chip
    whose edges form one closed convex ring, and every pad-inflated y
    bucket fits CONVEX_EDGE_CAP edges. The bucketed edges are the SAME
    f32 values as the cell's tier-1 row, so the lane is bit-identical to
    tier 1. Buckets are inflated by ``pad = 4·EDGE_BAND_K·eps(f32)·
    coord_scale`` so bucket-index rounding cannot drop a straddling edge.
    """
    KB = CONVEX_BUCKETS
    pad = 4.0 * EDGE_BAND_K * float(np.finfo(np.float32).eps) * coord_scale
    cell_convex = np.full(U, -1, dtype=np.int32)
    picked = []  # (u, (KB, EB) edge-index lists, ymin, inv)
    n_slots = (slot_geom >= 0).sum(axis=1)
    cand = np.nonzero(
        (~heavy_mask)
        & (n_slots == 1)
        & (slot_geom[:, 0] >= 0)
        & (~slot_core[:, 0])
        & (epc >= 3)
    )[0]
    for u in cand:
        k = int(epc[u])
        ef = cell_edges[u, :k].astype(np.float64)  # the probed f32 values
        # one closed ring: each edge's b is the next edge's a (cyclic)
        if not np.array_equal(ef[:, 2:4], np.roll(ef[:, 0:2], -1, axis=0)):
            continue
        d = ef[:, 2:4] - ef[:, 0:2]
        cr = d[:, 0] * np.roll(d[:, 1], -1) - d[:, 1] * np.roll(d[:, 0], -1)
        if not (np.all(cr >= 0) or np.all(cr <= 0)):
            continue
        ys = np.concatenate([ef[:, 1], ef[:, 3]])
        ymin, ymax = float(ys.min()), float(ys.max())
        height = ymax - ymin
        if not height > 4.0 * pad:  # degenerate: buckets would alias
            continue
        hb = height / KB
        elo = np.minimum(ef[:, 1], ef[:, 3])
        ehi = np.maximum(ef[:, 1], ef[:, 3])
        buckets = []
        for b in range(KB):
            blo = ymin + b * hb - pad
            bhi = ymin + (b + 1) * hb + pad
            sel = np.nonzero((ehi >= blo) & (elo <= bhi))[0]
            if sel.size > CONVEX_EDGE_CAP:
                buckets = None
                break
            buckets.append(sel)
        if buckets is None:
            continue
        picked.append((u, buckets, np.float32(ymin), np.float32(KB / height)))
    Cv = len(picked)
    if not Cv:
        return (
            cell_convex,
            np.zeros((0, KB, 8, 4), dtype=cell_edges.dtype),
            np.zeros((0, KB, 8), dtype=np.uint32),
            np.zeros((0,), dtype=np.int32),
            np.zeros((0, 3), dtype=np.float32),
        )
    EB = _round8(max(max(s.size for s in bk) for _, bk, _, _ in picked))
    convex_edges = np.zeros((Cv, KB, EB, 4), dtype=cell_edges.dtype)
    convex_ebits = np.zeros((Cv, KB, EB), dtype=np.uint32)
    convex_geom = np.zeros(Cv, dtype=np.int32)
    convex_ybin = np.zeros((Cv, 3), dtype=np.float32)
    for row, (u, buckets, ymin, inv) in enumerate(picked):
        cell_convex[u] = row
        convex_geom[row] = slot_geom[u, 0]
        convex_ybin[row] = (ymin, inv, np.float32((pad / 2.0) ** 2))
        for b, sel in enumerate(buckets):
            convex_edges[row, b, : sel.size] = cell_edges[u, sel]
            convex_ebits[row, b, : sel.size] = 1
    return cell_convex, convex_edges, convex_ebits, convex_geom, convex_ybin


# ------------------------------------------------------------------ probe


def _probe_slot(pcells: torch.Tensor, index: ChipIndex) -> torch.Tensor:
    """(N,) cell ids -> (N,) cell row u, -1 on miss — the multiply-shift
    hash probe. The int64 multiply wraps like the reference's uint64 one;
    ``>>`` is arithmetic, so the high bits are masked off after it."""
    T = index.table_cell.shape[0]
    s = 64 - int(np.log2(T))
    key = ((pcells * index.hash_mult[0]) >> s) & ((1 << (64 - s)) - 1)
    if index.table_pack.shape[0]:
        # slot-packed probe: one (N, B) gather carries cell + slot
        low = index.pack_low[0]
        ent = index.table_pack[key]  # (N, B)
        slotp = (ent & low).to(torch.int32)
        match = (
            (((ent ^ pcells[:, None]) & ~low) == 0)
            & (slotp > 0)
            & ((pcells[:, None] & low) == index.pack_low[1])
        )
        return torch.where(match, slotp - 1, -1).amax(dim=1)  # (N,)
    cand_cell = index.table_cell[key]  # (N, B)
    cand_slot = index.table_slot[key]  # (N, B)
    match = (cand_cell == pcells[:, None]) & (cand_slot >= 0)
    return torch.where(match, cand_slot, -1).amax(dim=1)


def _probe_counts(pcells: torch.Tensor, index: ChipIndex) -> torch.Tensor:
    """(3,) int64 on the device: (found, heavy-cell, convex-cell) point
    counts — the exact compaction-cap inputs, read in one transfer."""
    u = _probe_slot(pcells, index)
    found = u >= 0
    nf = found.sum()
    us = torch.clamp(u, min=0).long()
    if index.heavy_edges.shape[0]:
        nh = (torch.where(found, index.cell_heavy[us], -1) >= 0).sum()
    else:
        nh = torch.zeros_like(nf)
    if index.convex_edges.shape[0]:
        nc = (torch.where(found, index.cell_convex[us], -1) >= 0).sum()
    else:
        nc = torch.zeros_like(nf)
    return torch.stack([nf, nh, nc])


def _ray_parity(px, py, edges, bits, eps2=None):
    """XOR-accumulated crossing parity bits.

    px, py: (...,); edges: (..., E, 4) ax/ay/bx/by; bits: (..., E) int32
    (uint32 bit patterns; 0 for pad edges). Returns (...,) int32 where bit m is
    the ray-crossing parity of chip slot m. With ``eps2`` also returns the
    epsilon-band mask (within sqrt(eps2) of any real edge). torch has no
    XOR reduction, so the parity is accumulated in a loop over E.
    """
    ax, ay = edges[..., 0], edges[..., 1]
    bx, by = edges[..., 2], edges[..., 3]
    pyb, pxb = py[..., None], px[..., None]
    straddle = (ay > pyb) != (by > pyb)
    denom = torch.where(by == ay, torch.ones_like(by), by - ay)
    xcross = ax + (pyb - ay) * (bx - ax) / denom
    crossed = straddle & (pxb < xcross)
    vals = torch.where(crossed, bits, torch.zeros_like(bits))
    par = torch.zeros_like(vals[..., 0])
    for e in range(vals.shape[-1]):
        par = par ^ vals[..., e]
    if eps2 is None:
        return par
    e2 = torch.as_tensor(eps2, dtype=edges.dtype, device=edges.device)
    ex, ey = bx - ax, by - ay
    qx, qy = pxb - ax, pyb - ay
    dd = ex * ex + ey * ey
    t = torch.clamp(
        (qx * ex + qy * ey) / torch.where(dd == 0, torch.ones_like(dd), dd),
        0.0, 1.0,
    )
    rx, ry = qx - t * ex, qy - t * ey
    near = ((rx * rx + ry * ry <= e2) & (bits != 0)).any(dim=-1)
    return par, near


def _slot_best(parity, geoms, cores=None):
    """Smallest geom id among hit slots (SENTINEL if none).

    parity: (...,) int32 (uint32 bit patterns); geoms: (..., M) int32
    (-1 pad); cores: (..., M) bool or None.
    """
    m = torch.arange(geoms.shape[-1], dtype=parity.dtype, device=geoms.device)
    inside = ((parity[..., None] >> m) & 1) == 1
    hit = inside if cores is None else (cores | inside)
    hit = hit & (geoms >= 0)
    return torch.where(hit, geoms, _SENTINEL).amin(dim=-1).to(torch.int32)


def _compact(flag: torch.Tensor, cap: int):
    """Stream-compact: indices of up-to-``cap`` True rows (static shape).

    Returns (src (cap,) int64, valid (cap,) bool, overflow (N,) bool,
    pos (N,) int64): ``src`` lists the first ``cap`` flagged row ids
    (padded with 0, masked by ``valid``); ``overflow`` marks flagged rows
    beyond ``cap``; ``pos`` is each row's exclusive-prefix slot. Rows that
    do not land (unflagged, or beyond ``cap``) write into one drop row
    past the end, which is sliced off.
    """
    n = flag.shape[0]
    fi = flag.to(torch.int64)
    incl = torch.cumsum(fi, 0)
    pos = incl - fi  # exclusive prefix
    iota = torch.arange(n, device=flag.device)
    dest = torch.where(flag & (pos < cap), pos, cap)
    buf = torch.zeros(cap + 1, dtype=torch.int64, device=flag.device)
    buf[dest] = iota
    count = incl[-1] if n else torch.zeros((), dtype=torch.int64, device=flag.device)
    valid = torch.arange(cap, device=flag.device) < count
    return buf[:cap], valid, flag & (pos >= cap), pos


def _drop_scatter(n: int, valid, src, vals, fill) -> torch.Tensor:
    """(n,) ``fill`` with ``vals`` written at the valid ``src`` rows (the
    reference's unique ``.at[dest].set(mode="drop")``): invalid slots go
    to a drop row past the end, which is sliced off."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[torch.where(valid, src, n)] = vals
    return out[:n]


def _heavy_tier(
    px, py, hs, index, heavy_cap, k2_default, out_len, eps2,
    engine="gather",
):
    """Tier 2, shared by every probe plumbing mode: compact the rows whose
    cell is heavy, probe the wide rows, scatter back to ``out_len``.

    ``engine="kernel"`` runs the probe through
    :func:`~mosaic_tpu_torch.kernels.pip.pip_heavy_tiled` (the CUDA kernel
    on the card, its plain twin on the CPU) instead of the row gather +
    `_ray_parity` pipeline; the two are bit-identical.

    Returns (best2 (out_len,), over2 (out_len,) overflow mask,
    near2 (out_len,) | None when ``eps2`` is None)."""
    K2 = int(heavy_cap) if heavy_cap else k2_default
    K2 = max(8, min(K2, k2_default))
    src2, valid2, over2, _ = _compact(hs >= 0, K2)
    pq2 = torch.stack([px, py], dim=1)[src2]
    if engine == "kernel":
        from ..kernels.pip import pip_heavy_tiled

        rows2 = torch.where(valid2, hs[src2], -1)  # int32, as cell_heavy
        best2k, near2 = pip_heavy_tiled(
            pq2[:, 0], pq2[:, 1], rows2,
            index.heavy_edges, index.heavy_ebits, index.heavy_slot_geom,
            eps2=eps2,
        )
    else:
        h2 = torch.clamp(hs[src2], min=0).long()
        hedges, hebits = index.heavy_edges[h2], index.heavy_ebits[h2]
        r2 = _ray_parity(pq2[:, 0], pq2[:, 1], hedges, hebits, eps2=eps2)
        par2, near2 = r2 if eps2 is not None else (r2, None)
        best2k = _slot_best(par2, index.heavy_slot_geom[h2])
    best2 = _drop_scatter(out_len, valid2, src2, best2k, _SENTINEL)
    near_sc = (
        _drop_scatter(out_len, valid2, src2, near2, False)
        if eps2 is not None
        else None
    )
    return best2, over2, near_sc


#: lanes a forced-adaptive probe can pin (MOSAIC_PROBE_FORCE_LANE)
_PROBE_LANES = ("light", "heavy", "convex")


def _probe_modes():
    return ("scatter", "adaptive") + tuple(
        f"adaptive-{ln}" for ln in _PROBE_LANES
    )


def resolve_probe_mode(probe: str) -> str:
    """Normalize a ``probe`` argument, folding in the force-lane env knob
    ``MOSAIC_PROBE_FORCE_LANE=light|heavy|convex`` (rewrites ``adaptive``
    to ``adaptive-<lane>``)."""
    if probe not in _probe_modes():
        raise ValueError(
            f"probe must be one of {_probe_modes()}, got {probe!r}"
        )
    if probe == "adaptive":
        lane = os.environ.get("MOSAIC_PROBE_FORCE_LANE", "").strip().lower()
        if lane:
            if lane not in _PROBE_LANES:
                raise ValueError(
                    f"MOSAIC_PROBE_FORCE_LANE must be one of "
                    f"{_PROBE_LANES}, got {lane!r}"
                )
            return f"adaptive-{lane}"
    return probe


def pip_join_points(
    points: torch.Tensor,
    pcells: torch.Tensor,
    index: ChipIndex,
    heavy_cap: int | None = None,
    found_cap: int | None = None,
    edge_eps2=None,
    writeback: str = "scatter",
    lookup: str = "gather",
    compaction: str = "scatter",
    compact_block: int = 256,
    probe: str = "scatter",
    convex_cap: int | None = None,
):
    """(N,) int32 — smallest matching polygon row per point, -1 if none.

    ``points`` are the recentred, narrowed coordinates (same device and
    dtype as the index tables); ``pcells`` their int64 cells. The
    contract is the reference's (``mosaic_tpu/sql/join.py
    pip_join_points``): hash probe, stream compaction of found points
    (bounded by ``found_cap``; heavy points by ``heavy_cap``; convex
    points by ``convex_cap``), XOR crossing parity, slot-min, writeback.
    Points past a cap return :data:`OVERFLOW`. ``edge_eps2`` switches on
    the epsilon band and returns ``(out, near)``.

    ``writeback`` is ``"scatter"``, ``"gather"`` or ``"direct"`` (no
    tier-1 compaction) — identical results. ``probe="adaptive"`` routes
    heavy cells through the :func:`pip_heavy_tiled` kernel and convex
    single-chip cells through the y-bucketed lane; ``adaptive-light|
    heavy|convex`` pin one lane. Results are bit-identical to
    ``probe="scatter"``. ``lookup`` and ``compaction`` are validated and
    run the plain lanes (see the module docstring).
    """
    if writeback not in ("scatter", "gather", "direct"):
        raise ValueError(
            f"writeback must be scatter|gather|direct, got {writeback!r}"
        )
    if lookup not in ("gather", "mxu", "mxu2"):
        raise ValueError(f"lookup must be gather|mxu|mxu2, got {lookup!r}")
    if compaction not in ("scatter", "mxu"):
        raise ValueError(
            f"compaction must be scatter|mxu, got {compaction!r}"
        )
    if compact_block % 128:
        raise ValueError(
            f"compact_block must be a multiple of 128 (TPU lane width), "
            f"got {compact_block}"
        )
    if probe not in _probe_modes():
        raise ValueError(
            f"probe must be one of {_probe_modes()}, got {probe!r}"
        )
    adaptive = probe != "scatter"
    if adaptive and writeback == "direct":
        raise ValueError(
            "probe='adaptive' routes through compaction; it composes "
            "with writeback scatter|gather, not direct"
        )
    N = points.shape[0]
    u = _probe_slot(pcells, index)
    found = u >= 0
    banded = edge_eps2 is not None
    H = int(index.heavy_edges.shape[0])
    CV = int(index.convex_edges.shape[0])
    use_convex = adaptive and CV > 0 and probe in ("adaptive", "adaptive-convex")
    heavy_engine = (
        "kernel"
        if adaptive
        and probe in ("adaptive", "adaptive-heavy")
        and index.heavy_edges.dtype == torch.float32
        else "gather"
    )
    if use_convex:
        cvrow = torch.where(found, index.cell_convex[torch.clamp(u, min=0)], -1)
        conv = cvrow >= 0
        if banded:
            # band exactness holds only while eps² fits under the bucket
            # pad guard; wider bands fall back to tier 1
            guard2 = index.convex_ybin[torch.clamp(cvrow, min=0), 2]
            conv = conv & (
                torch.as_tensor(edge_eps2, dtype=guard2.dtype, device=guard2.device)
                <= guard2
            )
    else:
        conv = None

    if writeback == "direct":
        us = torch.clamp(u, min=0)
        best_parts, near_parts = [], []
        for s in range(0, N, _DIRECT_CHUNK):
            sl = slice(s, s + _DIRECT_CHUNK)
            uc = us[sl]
            r = _ray_parity(
                points[sl, 0], points[sl, 1],
                index.cell_edges[uc], index.cell_ebits[uc], eps2=edge_eps2,
            )
            par, near = r if banded else (r, None)
            best_parts.append(_slot_best(
                par, index.cell_slot_geom[uc], index.cell_slot_core[uc]
            ))
            near_parts.append(near)
        best = (
            torch.cat(best_parts) if best_parts
            else torch.empty(0, dtype=torch.int32, device=points.device)
        )
        near1 = (
            (torch.cat(near_parts) if near_parts
             else torch.zeros(0, dtype=torch.bool, device=points.device))
            if banded else None
        )
        best = torch.where(found, best, _SENTINEL)
        if H:
            hs = torch.where(found, index.cell_heavy[us], -1)
            best2, over2, near_sc = _heavy_tier(
                points[:, 0], points[:, 1], hs, index, heavy_cap, N, N,
                edge_eps2,
            )
            best = torch.minimum(best, best2)
            best = torch.where(over2, _OVF_MARK, best)
            if banded:
                near1 = near1 | near_sc
        out = torch.where(best == _SENTINEL, -1, best)
        out = torch.where(best == _OVF_MARK, OVERFLOW, out).to(torch.int32)
        if banded:
            return out, near1 & found
        return out

    light = found if conv is None else (found & ~conv)
    K1 = int(found_cap) if found_cap else N
    K1 = max(8, min(K1, N))
    src1, valid1, over1, pos1 = _compact(light, K1)
    us = torch.clamp(u[src1], min=0).long()  # (K1,)
    pxy = points[src1]
    px, py = pxy[:, 0], pxy[:, 1]

    r1 = _ray_parity(
        px, py, index.cell_edges[us], index.cell_ebits[us], eps2=edge_eps2
    )
    parity, near1 = r1 if banded else (r1, None)
    best1 = _slot_best(parity, index.cell_slot_geom[us], index.cell_slot_core[us])
    best1 = torch.where(valid1, best1, _SENTINEL)

    if H:
        # tier 2: compact again to the points whose cell is heavy
        hs = torch.where(valid1, index.cell_heavy[us], -1)
        best2, over2, near_sc = _heavy_tier(
            px, py, hs, index, heavy_cap, K1, K1, edge_eps2,
            engine=heavy_engine,
        )
        best1 = torch.minimum(best1, best2)
        # an overflowed tier-2 point has an unknown answer even if tier 1
        # hit: mark it (the mark survives the writeback verbatim)
        best1 = torch.where(over2, _OVF_MARK, best1)
        if banded:
            near1 = near1 | near_sc

    if use_convex:
        # convex lane: compact, y-bucket, probe at most EB edges/point
        K3 = int(convex_cap) if convex_cap else N
        K3 = max(8, min(K3, N))
        src3, valid3, over3, pos3 = _compact(conv, K3)
        cv3 = torch.clamp(cvrow[src3], min=0).long()
        pq3 = points[src3]
        px3, py3 = pq3[:, 0], pq3[:, 1]
        yb = index.convex_ybin[cv3]
        KB = int(index.convex_edges.shape[1])
        EB = int(index.convex_edges.shape[2])
        b3 = torch.clamp(
            torch.floor((py3 - yb[:, 0]) * yb[:, 1]).to(torch.int32),
            0, KB - 1,
        )
        flat3 = cv3 * KB + b3
        ce = index.convex_edges.reshape(CV * KB, EB, 4)[flat3]
        cb = index.convex_ebits.reshape(CV * KB, EB)[flat3]
        r3 = _ray_parity(px3, py3, ce, cb, eps2=edge_eps2)
        par3, near3 = r3 if banded else (r3, None)
        g3 = index.convex_geom[cv3]
        hit3 = ((par3 & 1) == 1) & (g3 >= 0) & valid3
        best3 = torch.where(hit3, g3, _SENTINEL)

    # return compacted results to the full point axis (the convex lane's
    # rows are disjoint from the light lane's)
    if writeback == "gather":
        slot = torch.clamp(pos1, 0, K1 - 1)
        best = torch.where(light, best1[slot], _SENTINEL)
        if use_convex:
            slot3 = torch.clamp(pos3, 0, K3 - 1)
            best = torch.where(conv, best3[slot3], best)
    else:
        best = _drop_scatter(N, valid1, src1, best1, _SENTINEL)
        if use_convex:
            best = torch.where(
                _drop_scatter(N, valid3, src3, valid3, False),
                _drop_scatter(N, valid3, src3, best3, _SENTINEL),
                best,
            )
    out = torch.where(best == _SENTINEL, -1, best)
    out = torch.where(best == _OVF_MARK, OVERFLOW, out)
    out = torch.where(over1, OVERFLOW, out)
    if use_convex:
        out = torch.where(over3, OVERFLOW, out)
    out = out.to(torch.int32)
    if banded:
        if writeback == "gather":
            near = light & ~over1 & near1[slot]
            if use_convex:
                near = torch.where(conv, ~over3 & near3[slot3], near)
        else:
            near = _drop_scatter(N, valid1, src1, near1, False)
            if use_convex:
                near = torch.where(
                    _drop_scatter(N, valid3, src3, valid3, False),
                    _drop_scatter(N, valid3, src3, near3, False),
                    near,
                )
        return out, near
    return out


def _next_pow2(n: int, lo: int = 16) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def pip_join(
    points,
    polygons: PackedGeometry | None,
    index_system: IndexSystem,
    resolution: "int | None" = None,
    chip_index: ChipIndex | None = None,
    batch_size: int | None = None,
    recheck: bool | None = None,
    cell_dtype=None,
    writeback: "str | None" = None,
    lookup: str | None = None,
    cell_margin_k: float | None = None,
    edge_band_k: float | None = None,
    probe: "str | None" = None,
    mesh=None,
    profile=None,
    device=None,
) -> np.ndarray:
    """Managed join: tessellate ``polygons`` (unless ``chip_index`` is
    given), assign cells to ``points`` on the device and return the
    matched polygon row per point (-1 = no polygon) as a numpy int32 array.

    Runs on the card unless ``device="cpu"``; a prebuilt ``chip_index``
    must live on that device. ``batch_size`` chunks the point axis. Each
    chunk crosses to the device once, in float64; the device recentres it
    on ``chip_index.border.shift`` and narrows it to the tables' dtype,
    the same bits as numpy's ``(points - host.shift).astype(float32)``. The
    compaction caps are sized exactly from the three device counts
    (`_probe_counts`) and grow through `run_escalating` should a cap
    overflow anyway (shrunken by `runtime.faults`), so :data:`OVERFLOW`
    never escapes. Every device step runs through
    ``dispatch.guarded_call("pip_join.device", ...)``: under the site's
    watchdog deadline, with transient failures retried. Past the retry
    budget a join on the CPU degrades to the exact f64 host oracle and the
    result is flagged :class:`~mosaic_tpu_torch.runtime.DegradedResult`; a
    join on the card raises :class:`~mosaic_tpu_torch.runtime.RetryExhausted`
    instead, as its work never moves to the CPU. The port's own device
    errors (no card, a kernel that does not build or launch, a CUDA error)
    are never transient: they propagate.

    ``recheck`` (default: the ``exact_recheck`` config flag) switches on
    the epsilon-band recheck — the answer is then the exact f64 answer.
    Points whose f32 cell-rounding margin is below
    ``cell_margin_k``·eps (default :data:`CELL_MARGIN_K`) re-join once,
    band-compacted, against their runner-up cell
    (`IndexSystem.point_to_cell_alt`); only those whose two answers
    differ, cell-corner points, invalid alternates, and points within
    ``edge_band_k``·eps·coord_scale (default :data:`EDGE_BAND_K`) of a
    chip edge of either cell probed go to the f64 oracle
    (:func:`recheck_oracle`, on the join's device). It answers from every
    cell whose boundary ring holds the point: an H3 cell's edges are not
    the straight edges of the ring its chips are clipped to, so a point
    within about 1e-9 degrees of a cell edge may lie in a neighbour's
    ring, whose chips then answer it where :func:`host_join`, which reads
    only the f64 cell's chips, would miss a zone. Everywhere else the
    answer is :func:`host_join`'s. Requires the index's ``host``
    companion.

    ``cell_dtype`` is the dtype cells are computed in. The default is
    float32, the port's device coordinate type, except for an exact join
    on an index system without cell margins (the custom grid): no recheck
    can then correct an f32 cell, so its cells are computed in float64,
    as the reference computes them from its f64 input. With margins (H3,
    BNG) the recheck makes f32 cells exact. ``writeback``/``lookup``/
    ``probe`` are the knobs of :func:`pip_join_points`.

    ``profile`` takes a `tune.TuningProfile`; its knobs apply with the
    one documented precedence — explicit argument > env knob > profile >
    built-in default (`tune/resolve.py`). Profile-consumed knobs here:
    ``resolution``, ``probe``, ``writeback``, ``lookup``, ``batch_size``
    (pass ``batch_size=0`` to force the unbatched path past a profile's
    recommendation).

    While stage timing is on (`obs/trace.py stage_timing_on`: a torch
    profiler records, or ``MOSAIC_TRACE_STAGES=1``), the single-device
    lane records the stage spans ``join.pip.h2d``, ``join.pip.prepare``
    (the device's shift and cast), ``join.pip.cells``, ``join.pip.counts``,
    ``join.pip.probe`` and ``join.pip.d2h`` under ``join.pip``, the
    prepare, cells and probe stages device-timed, read once the answer is
    on the host. With ``recheck`` it adds ``join.pip.narrow`` (the
    narrow re-join, device-timed over the chunk's points) and
    ``join.pip.oracle`` (the f64 oracle of the tie rows), each with its
    ``rows``, which the metric bridge counts as
    ``join.recheck_rows{lane="band"|"oracle"}``. The meshed lane records
    none.

    ``mesh`` routes each chunk through the dispatch core's bucketed
    data-parallel lane (`dispatch.DispatchCore`): points padded to the
    ladder bucket and sharded over the mesh with the ChipIndex
    replicated, full per-shard caps (no count read-back, no escalation),
    bit for bit the single-device answer; under ``probe="adaptive"`` on
    the card each shard launches ``pip_heavy_tiled``. Takes a device
    count (real devices of the join's kind), a `parallel.mesh.Mesh`, or
    None (the ``MOSAIC_MESH`` knob). A chunk must fit the ladder's top
    bucket (``batch_size``). Requires ``recheck=False``: the
    epsilon-band path stays single-device.
    """
    # profile-consumed knobs fold HERE, at the host entry point: explicit
    # argument > env knob > profile > built-in default (tune/resolve.py).
    # lookup's default is None, as the reference's, so the tune_resolve
    # event names the same value; every device runs the gather lane.
    knobs = _tune_resolve.resolve_knobs(
        "pip_join", profile,
        explicit={
            "resolution": resolution, "probe": probe,
            "writeback": writeback, "lookup": lookup,
            "batch_size": batch_size,
        },
        defaults={
            "resolution": None, "probe": "scatter", "writeback": "scatter",
            "lookup": None, "batch_size": None,
        },
    )
    resolution, writeback = knobs["resolution"], knobs["writeback"]
    lookup = knobs["lookup"] or "gather"
    batch_size = knobs["batch_size"] or None  # 0 = explicitly unbatched
    if resolution is None:
        raise ValueError(
            "pip_join needs a resolution — pass it explicitly or via a "
            "profile that recommends one"
        )
    dev = resolve_device(device)
    resolution = index_system.resolution_arg(resolution)
    probe = resolve_probe_mode(knobs["probe"])
    if probe != "scatter" and writeback == "direct":
        raise ValueError(
            "probe='adaptive' requires writeback scatter|gather"
        )
    if chip_index is None:
        table = tessellate(polygons, index_system, resolution, keep_core_geoms=False)
        chip_index = build_chip_index(table, device=dev)
    elif chip_index.device.type != dev.type:
        raise ValueError(
            f"chip_index lives on {chip_index.device}, the join runs on {dev}"
        )
    if recheck is None:
        recheck = current_config().exact_recheck
    dev = chip_index.device
    mesh = _dispatch.resolve_mesh(mesh, device=dev)
    if mesh is not None and recheck:
        raise ValueError(
            "pip_join(mesh=...) runs the bucketed sharded dispatch lane, "
            "which does not support the epsilon-band recheck yet — pass "
            "recheck=False (or drop the mesh for the exact-recheck path)"
        )
    host: HostRecheck | None = getattr(chip_index, "host", None)
    if recheck and host is None:
        raise ValueError(
            "exact_recheck needs the index's f64 host companion — present "
            "on build_chip_index products; rebuild the index in-process "
            "or restore it via HostRecheck.from_arrays"
        )
    raw = np.asarray(points, dtype=np.float64)
    vdt = chip_index.border.verts.dtype
    if cell_dtype is not None:
        cdt = _as_torch_dtype(cell_dtype)
    elif recheck and not has_cell_margins(index_system):
        cdt = torch.float64
    else:
        cdt = FLOAT
    n = raw.shape[0]
    if recheck:
        # the edge band, rounded once to the table dtype on the host: the
        # probe and its kernel read it as a number, never from the device
        ebk = EDGE_BAND_K if edge_band_k is None else float(edge_band_k)
        np_dtype = np.dtype(str(vdt).removeprefix("torch."))
        eps2 = float(np_dtype.type(
            (ebk * float(np.finfo(np_dtype).eps) * host.coord_scale) ** 2
        ))
    need_counts = writeback != "direct" or chip_index.num_heavy_cells
    core = (
        None
        if mesh is None
        else _dispatch.core_for(
            chip_index, index_system, resolution,
            writeback=writeback, lookup=lookup, probe=probe,
            cell_dtype=cell_dtype, mesh=mesh,
        )
    )

    def assign(chunk: np.ndarray):
        """A chunk's recentred points, cells (and margins), and its three
        probe counts."""
        host_pts = np.ascontiguousarray(chunk)
        m = host_pts.shape[0]
        with _obs_trace.stage_span("join.pip.h2d", bytes=host_pts.nbytes):
            pts = torch.from_numpy(host_pts).to(dev)
        # recentre in f64 and narrow on the device, from the one f64 copy:
        # a round-to-nearest cast of the f64 difference, numpy's bits
        with _obs_trace.stage_span("join.pip.prepare", device=dev, points=m):
            shifted = (pts - chip_index.border.shift).to(vdt)
        with _obs_trace.stage_span("join.pip.cells", device=dev, points=m):
            pts = pts.to(cdt)
            if recheck:
                cells, margins = _dispatch.cells_prog(
                    index_system, resolution, "margin"
                )(pts)
            else:
                cells = _dispatch.cells_prog(index_system, resolution, "cells")(pts)
                margins = None
        counts = None
        if need_counts:
            with _obs_trace.stage_span("join.pip.counts"):
                counts = _probe_counts(cells, chip_index).tolist()
        return pts, shifted, cells, margins, counts

    def run(chunk: np.ndarray) -> np.ndarray:
        if core is not None:
            # the sharded bucketed lane: pad to the ladder, dispatch data
            # parallel at full per-shard caps (overflow structurally
            # impossible: no count read-back, no escalation), slice the
            # pad off. RetryExhausted reaches `run_resilient` as on every
            # lane.
            padded, nn = core.ladder.pad(chunk)
            return _dispatch.guarded_call(
                "pip_join.device", core.execute_padded, padded
            )[:nn]
        m = chunk.shape[0]
        pts, shifted, cells, margins, counts = _dispatch.guarded_call(
            "pip_join.device", assign, chunk
        )
        if writeback == "direct":
            fcap = ccap = None
            hcap = (
                min(_next_pow2(counts[1] + 1), m)
                if chip_index.num_heavy_cells
                else None
            )
            caps = _faults.clamp_caps({"heavy_cap": hcap})
            hcap = caps["heavy_cap"]
        else:
            nf, nh, nc = counts
            fcap = min(_next_pow2(nf + 1), m)
            hcap = (
                min(_next_pow2(nh + 1), fcap)
                if chip_index.num_heavy_cells
                else None
            )
            ccap = (
                min(_next_pow2(nc + 1), m)
                if probe != "scatter" and chip_index.num_convex_cells
                else None
            )
            # fault injection may clamp the exactly-sized caps (no-op
            # without an active plan); the escalation loop grows them back
            caps = _faults.clamp_caps(
                {"found_cap": fcap, "heavy_cap": hcap, "convex_cap": ccap}
            )
            fcap, hcap, ccap = (
                caps["found_cap"], caps["heavy_cap"], caps["convex_cap"]
            )
            if probe != "scatter":
                # lane populations: how the router splits this chunk
                _telemetry.record(
                    "probe_route", n=m, probe=probe,
                    found=nf, heavy=nh, convex=nc, light=nf - nc,
                )
        # every cap that exists escalates together toward the row-count
        # ceiling, at which overflow is structurally impossible
        grow = {k: v for k, v in caps.items() if v is not None}
        ceilings = {k: m for k in grow}
        band = eps2 if recheck else None

        def attempt(c):
            # the copy back ends the attempt, so the watchdog's deadline
            # covers the device work
            with _obs_trace.stage_span("join.pip.probe", device=dev, points=m):
                r = pip_join_points(
                    shifted, cells, chip_index,
                    heavy_cap=c.get("heavy_cap", hcap),
                    found_cap=c.get("found_cap", fcap), edge_eps2=band,
                    writeback=writeback, lookup=lookup, probe=probe,
                    convex_cap=c.get("convex_cap", ccap),
                )
            with _obs_trace.stage_span("join.pip.d2h"):
                if band is None:
                    return r.cpu().numpy()
                return r[0].cpu().numpy(), r[1].cpu().numpy()

        if not recheck:
            out, _ = run_escalating(
                lambda c: _dispatch.guarded_call("pip_join.device", attempt, c),
                grow, ceilings,
                overflow_count=lambda o: int((o == OVERFLOW).sum()),
                stage="pip_join",
            )
            return out

        # --- epsilon-band recheck ------------------------------------
        (out, host_mask), _ = run_escalating(
            lambda c: _dispatch.guarded_call("pip_join.device", attempt, c),
            grow, ceilings,
            overflow_count=lambda r: int((r[0] == OVERFLOW).sum()),
            stage="pip_join.recheck",
        )
        if margins is not None:
            cmk = CELL_MARGIN_K if cell_margin_k is None else float(cell_margin_k)
            km = cmk * float(torch.finfo(margins.dtype).eps)
            t_rc = time.perf_counter()
            with _obs_trace.stage_span(
                "join.pip.narrow", device=dev, points=m
            ) as sp:
                nar = _dispatch.guarded_call(
                    "pip_join.device", _narrow_rejoin, pts, shifted, margins,
                    km, index_system, resolution, chip_index, lookup, eps2,
                )
                if sp is not None:
                    sp.set(rows=0 if nar is None else nar[0])
            if nar is not None:
                n_flag, cap, src_np, alt_join = nar
                if alt_join is None:  # system without alternate-rounding
                    host_mask[src_np] = True
                    _telemetry.record(
                        "recheck_narrow", n=m, band=n_flag, cap=cap,
                        ties=n_flag, mode="host_all",
                        seconds=round(time.perf_counter() - t_rc, 6),
                    )
                else:
                    caps2, r_alt, near_alt, vertex, alt_np = alt_join
                    tie = (r_alt != out[src_np]) | near_alt | vertex | (alt_np < 0)
                    host_mask[src_np[tie]] = True
                    _telemetry.record(
                        "recheck_narrow", n=m, band=n_flag, cap=cap,
                        caps=caps2, ties=int(tie.sum()), mode="alt_rejoin",
                        seconds=round(time.perf_counter() - t_rc, 6),
                    )
        rows = np.nonzero(host_mask)[0]
        with _obs_trace.stage_span("join.pip.oracle", rows=int(rows.size)):
            if rows.size:
                out[rows] = recheck_oracle(
                    chunk[rows], host, index_system, resolution, device=dev
                )
        return out

    def run_resilient(chunk: np.ndarray) -> np.ndarray:
        """`run`, degrading to the exact f64 host oracle when the device
        path fails past the transient-retry budget (result flagged
        :class:`DegradedResult` — never a silent zero/wrong answer). Only
        a join on the CPU degrades: on the card a retried stall queues
        behind the hung work, and the chunk's work stays on the card, so
        :class:`RetryExhausted` propagates."""
        try:
            return run(chunk)
        except RetryExhausted as e:
            if host is None or dev.type != "cpu":
                raise
            _telemetry.record(
                "degraded", label="pip_join", attempts=e.attempts,
                error=repr(e.last)[:200],
            )
            logging.getLogger("mosaic_tpu_torch.runtime").warning(
                "pip_join: device path failed %d times (%r); answering "
                "from the f64 host oracle", e.attempts, e.last,
            )
            return DegradedResult.wrap(
                host_join(chunk, host, index_system, resolution),
                reason=f"pip_join device retries exhausted ({e.last!r})"[:300],
                attempts=e.attempts,
            )

    def run_spanned(chunk: np.ndarray) -> np.ndarray:
        """One lane span per chunk when routing is pinned:
        `join.probe.<lane>` attributes the chunk's wall clock to that lane
        (the lane populations of `adaptive` ride the `probe_route`
        event instead)."""
        if probe.startswith("adaptive-"):
            with _obs_trace.span(
                f"join.probe.{probe.removeprefix('adaptive-')}",
                n=chunk.shape[0],
            ):
                return run_resilient(chunk)
        return run_resilient(chunk)

    # one span per pip_join call: escalation/retry/degradation/recheck
    # events inside attach to it; its device-timed stages are read once
    # the answer is on the host
    with _obs_trace.span(
        "join.pip", n=n, recheck=bool(recheck), probe=probe
    ), _obs_trace.device_stages():
        if batch_size is None or n <= batch_size:
            return run_spanned(raw)
        out = np.empty(n, dtype=np.int32)
        degraded: list[DegradedResult] = []
        for s in range(0, n, batch_size):
            r = run_spanned(raw[s : s + batch_size])
            if isinstance(r, DegradedResult):
                degraded.append(r)
            out[s : s + batch_size] = r
        if degraded:
            return DegradedResult.wrap(
                out,
                reason=degraded[0].reason,
                attempts=max(d.attempts for d in degraded),
                detail={"degraded_batches": len(degraded)},
            )
        return out


def _narrow_rejoin(
    pts, shifted, margins, km, index_system, resolution, chip_index, lookup,
    eps2,
):
    """The recheck's band-compacted narrow re-join, on the device.

    The points whose first cell margin is below ``km`` are compacted once
    (`_compact`) and re-joined once against their runner-up cell, on the
    scatter probe with caps sized exactly from the band's own counts (pad
    rows duplicate row 0, so the counts bound the band from above), and
    with the main probe's edge band ``eps2``: a point near a chip edge of
    its runner-up cell is a tie too, as its f32 answer there may be
    wrong. The full point axis is never re-probed. Returns None when no
    point is in the band, else ``(n_flag, cap, src, alt_join)`` on the
    host: ``src`` the band's row ids, and ``alt_join`` None for a system
    without an alternate rounding, else ``([found_cap, heavy_cap], alt
    result, alt edge-band flags, vertex flags, alt cells)`` of the band's
    rows.
    """
    flagged = margins[:, 0] < km
    n_flag = int(flagged.sum())
    if not n_flag:
        return None
    cap = min(_next_pow2(n_flag), pts.shape[0])
    src, _, _, _ = _compact(flagged, cap)
    alt = _dispatch.cells_prog(index_system, resolution, "alt")(pts[src])
    src_np = src[:n_flag].cpu().numpy()
    if alt is None:
        return n_flag, cap, src_np, None
    nf2, nh2, _ = _probe_counts(alt, chip_index).tolist()
    fcap2 = min(_next_pow2(nf2 + 1), cap)
    hcap2 = (
        min(_next_pow2(nh2 + 1), fcap2) if chip_index.num_heavy_cells else None
    )
    r_alt, near_alt = pip_join_points(
        shifted[src], alt, chip_index, heavy_cap=hcap2, found_cap=fcap2,
        edge_eps2=eps2, lookup=lookup,
    )
    vertex = (margins[src[:n_flag], 1] < km).cpu().numpy()
    alt_np = alt[:n_flag].cpu().numpy()
    return n_flag, cap, src_np, (
        [fcap2, hcap2], r_alt[:n_flag].cpu().numpy(),
        near_alt[:n_flag].cpu().numpy(), vertex, alt_np,
    )


def join_cache_stats(emit: bool = True) -> dict:
    """The join's view of the dispatch cache registry
    (`dispatch.cache_stats` is the full surface): ``{"cells_prog":
    {hits, misses, maxsize, currsize}, "kernels": {libraries,
    backend_compiles}}``. The `cells_prog` entry count is the number of
    live (index system, resolution, variant) keys, each holding its
    index system. Emits one ``join_cache_stats`` event (``emit=False``
    reads silently)."""
    stats = _dispatch.join_cache_view()
    if emit:
        _telemetry.record("join_cache_stats", **stats)
    return stats


def clear_join_caches() -> dict:
    """Release the join's cell-assignment cache (it regrows on next
    use); returns the pre-clear :func:`join_cache_stats`.
    `dispatch.clear_caches` drops every registered cache. Emits
    ``join_caches_cleared``."""
    stats = join_cache_stats(emit=False)
    _dispatch.clear_caches(names=("cells_prog",), emit=False)
    _telemetry.record("join_caches_cleared", **stats)
    return stats


def has_cell_margins(index_system: IndexSystem) -> bool:
    """Does ``index_system`` give cell-rounding margins? A system that
    keeps the base :meth:`IndexSystem.point_to_cell_margin` returns None
    margins, so the recheck cannot flag a cell that f32 rounded wrong."""
    return (
        type(index_system).point_to_cell_margin
        is not IndexSystem.point_to_cell_margin
    )


def _as_torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, np.dtype(dt).name)
